# Entry points of the port, run as modules:
#
#   serve.py — LM decode serving (``serve_lm``; the default workload,
#              ``python -m repro_torch.launch.serve --workload lm``) and
#              SortServer, the continuous-batching grid-sort server
#              (``python -m repro_torch.launch.serve --workload sort``)
#   train.py — the LM zoo's presets (the training loop is not ported yet)
#   mesh.py  — SortMesh, the instance sharding over device slots
