# Runnable examples of the port:
#
#   python -m repro_torch.examples.self_organizing_gaussians
#       the paper's Self-Organizing Gaussians workload (section IV-B)
