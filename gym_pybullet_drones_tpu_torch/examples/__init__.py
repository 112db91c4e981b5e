"""Example entry points of the port: `python -m
gym_pybullet_drones_tpu_torch.examples.learn` and `.train_to_threshold`."""
