# Entry points of the port, run as modules:
#
#   serve.py — SortServer, the continuous-batching grid-sort server
#              (``python -m repro_torch.launch.serve --workload sort``)
