# Entry points of the port, run as modules:
#
#   serve.py — LM decode serving (``serve_lm``; the default workload,
#              ``python -m repro_torch.launch.serve --workload lm``) and
#              SortServer, the continuous-batching grid-sort server
#              (``python -m repro_torch.launch.serve --workload sort``)
#   train.py — LM training (``python -m repro_torch.launch.train``):
#              synthetic data, Adam, checkpoints, TrainSupervisor, the
#              presets the serve CLI names too
#   steps.py — make_train_step: one train step as a function of
#              (state, batch); the sharded builders of every shape cell
#              (build_cell, lower_cell)
#   mesh.py  — SortMesh, the instance sharding over device slots; the LM
#              production meshes (make_production_mesh)
#   dryrun.py — every (arch x shape x mesh) cell on meta tensors under
#              the fake process group
#              (``python -m repro_torch.launch.dryrun --all``)
