"""Example entry points of the port: `python -m
gym_pybullet_drones_tpu_torch.examples.<name>` for `learn`,
`train_to_threshold`, `train_population`, `pid`, `pid_velocity`,
`downwash`, `routing` and `swarm`."""
