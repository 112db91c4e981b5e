"""Data-parallel training over ranks: process groups, the env batch
split over them, collectives (one process a rank, `torch.distributed`)."""
from gym_pybullet_drones_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    gather_train_state,
    make_mesh,
    make_sharded_update,
    shard_train_state,
)
from gym_pybullet_drones_tpu_torch.parallel.distributed import (  # noqa: F401
    global_env_batch,
    initialize,
    local_env_batch,
)
