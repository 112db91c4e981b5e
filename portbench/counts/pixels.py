"""The work of the pixel trainer, counted from the configuration's shapes:
the NatureCNN's FLOPs, the ray tracer's operations and bytes, the DYN
step kernel's bytes, and a PPO update's FLOPs, against the H100's
published peaks (`counts/work.py`'s).

They read the configuration file, never what ran: a change that fuses,
graphs or replaces a kernel leaves the work as it was, so a roofline
share moves only with the time.

- The NatureCNN (`policy`: the trunk's (channels, kernel, stride) with
  VALID padding, the dense width, a mean head of the action width and a
  value head of 1): a multiply-add counts two FLOPs; biases, ReLUs and
  the pixels' scaling are not counted.  The backward pass counts twice
  the forward's (the input's and the weights' gradients), so forward and
  backward are three times the forward.
- The render kernel: 420 float32 operations a pixel (the landmark scene
  and one drone an env: the ray, two spheres, one drone sphere, two
  boxes, the plane, the shading; the count of the port's kernel table),
  and 16 bytes of rgba a pixel written plus 28 bytes a camera read (its
  position and quaternion).
- The DYN step kernel (K1) without the kinematic block: 13 state rows and
  4 rpm rows read, 16 state rows written, 4 bytes each, a column; 30
  float32 operations of the mixer and 175 a substep.
"""
from __future__ import annotations

from portbench.counts.work import act_width, bound_s

RENDER_OPS_PER_PIXEL = 420
RENDER_BYTES_PER_PIXEL = 16        # one float4 of rgba written
RENDER_BYTES_PER_CAMERA = 28       # position (3) and quaternion (4) read
K1_ROWS = 13 + 4 + 16              # state read, rpm read, state written
K1_MIXER_OPS, K1_SUBSTEP_OPS = 30, 175


def image_shape(config: dict) -> tuple:
    """(H, W, C) of one camera image."""
    return tuple(int(x) for x in config["policy"]["image"])


def cnn_layer_flops(config: dict) -> dict:
    """Forward FLOPs of one image, by layer: `conv<i>`, `dense`, `heads`
    (the mean and the value at the configuration's action width)."""
    h, w, c = image_shape(config)
    out = {}
    for i, (ch, k, s) in enumerate(config["policy"]["trunk"]):
        h, w = (h - k) // s + 1, (w - k) // s + 1
        out[f"conv{i + 1}"] = 2 * h * w * ch * k * k * c
        c = ch
    dense = int(config["policy"]["dense"])
    out["dense"] = 2 * h * w * c * dense
    out["heads"] = 2 * dense * (act_width(config) + 1)
    return out


def cnn_flops(config: dict) -> tuple:
    """(forward FLOPs of one image, forward and backward FLOPs of one)."""
    fwd = sum(cnn_layer_flops(config).values())
    return fwd, 3 * fwd


def render_work(cameras: int, config: dict) -> tuple:
    """(float32 operations, bytes) of one render launch of `cameras`."""
    h, w, _ = image_shape(config)
    px = cameras * h * w
    return (RENDER_OPS_PER_PIXEL * px,
            RENDER_BYTES_PER_PIXEL * px + RENDER_BYTES_PER_CAMERA * cameras)


def render_bound_s(cameras: int, config: dict) -> float:
    return bound_s(*render_work(cameras, config))


def k1_work(columns: int, config: dict) -> tuple:
    """(float32 operations, bytes) of one DYN step launch of `columns`."""
    env = config["env"]
    sub = int(env["pyb_freq"]) // int(env["ctrl_freq"])
    return ((K1_MIXER_OPS + K1_SUBSTEP_OPS * sub) * columns,
            4 * K1_ROWS * columns)


def k1_bound_s(columns: int, config: dict) -> float:
    return bound_s(*k1_work(columns, config))


def update_flops(config: dict, num_envs: int, rollout_steps: int) -> float:
    """FLOPs of one PPO update: the CNN's forward pass on every rollout
    sample and on the last observation, its forward and backward pass on
    every sample of every epoch, a render and a DYN step each control
    step."""
    fwd, fwd_bwd = cnn_flops(config)
    epochs = int(config["ppo"]["update_epochs"])
    samples = num_envs * rollout_steps
    cameras = num_envs * int(config["env"]["num_drones"])
    per_step = render_work(cameras, config)[0] + k1_work(cameras, config)[0]
    return (samples + num_envs) * fwd + epochs * samples * fwd_bwd \
        + rollout_steps * per_step
