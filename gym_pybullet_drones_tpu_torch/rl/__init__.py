"""PPO training on the card."""
from gym_pybullet_drones_tpu_torch.rl.ppo import (  # noqa: F401
    Draws,
    PPOConfig,
    TrainState,
    Transition,
    make_train,
)
