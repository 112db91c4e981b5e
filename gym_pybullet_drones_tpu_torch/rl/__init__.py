"""PPO training on the card: one policy (`make_train`) or a population
of K policies in one trainer (`make_train_population`)."""
from gym_pybullet_drones_tpu_torch.rl.ppo import (  # noqa: F401
    Draws,
    PPOConfig,
    TrainState,
    Transition,
    make_arrival_rate,
    make_train,
)
from gym_pybullet_drones_tpu_torch.rl.population import (  # noqa: F401
    make_train_population,
    member_state,
)
