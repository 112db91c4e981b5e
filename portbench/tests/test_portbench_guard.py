"""The import guard compares whole top-level names."""
from portbench.run import forbidden_modules


def test_port_passes():
    assert forbidden_modules({"gym_pybullet_drones_tpu_torch",
                              "gym_pybullet_drones_tpu_torch.rl.ppo",
                              "torch", "numpy", "jaxtyping"}) == []


def test_jax_package_and_jax_caught():
    assert forbidden_modules({"gym_pybullet_drones_tpu.envs.core",
                              "gym_pybullet_drones_tpu_torch"}) \
        == ["gym_pybullet_drones_tpu"]
    assert forbidden_modules({"jax.numpy", "jaxlib", "flax.linen"}) \
        == ["flax", "jax", "jaxlib"]
