# Runnable examples of the port:
#
#   python -m repro_torch.examples.quickstart
#       1024 RGB colours on a 32 x 32 grid (paper section IV-A, Fig. 1)
#   python -m repro_torch.examples.image_grid_sorting
#       clustered 50-d product features on a grid (paper section IV-A)
#   python -m repro_torch.examples.batched_image_grids
#       several catalogs x restarts as one batch
#
#   python -m repro_torch.examples.self_organizing_gaussians
#       the paper's Self-Organizing Gaussians workload (section IV-B)
#
#   python -m repro_torch.examples.train_lm
#       LM training through failure recovery (the loss must fall)
