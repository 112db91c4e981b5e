"""The work a step needs, counted from the configuration's shapes: the
float32 operations and the bytes of one fused env step, and the policy's
FLOPs, against the H100's published peaks.

The operation counts are a frozen copy of the arithmetic that counts the
device functions of the port's env step (the nonzero terms of each
formula; a sqrt, a division or a trig call count one).  They read the
configuration, never the kernel that ran: a change that fuses, graphs or
replaces a kernel leaves the work of a step as it was, so a roofline
share moves only with the time.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
FP32_FLOPS_PER_S = 67e12    # H100 SXM, float32 outside the tensor cores

GND_MODES = ("pyb_gnd", "pyb_gnd_drag_dw")
DRAG_MODES = ("pyb_drag", "pyb_gnd_drag_dw")
DW_MODES = ("pyb_dw", "pyb_gnd_drag_dw")
PID_ACTS = ("pid", "vel", "one_d_pid")
ACT_DIMS = {"rpm": 4, "vel": 4, "pid": 3, "one_d_rpm": 1, "one_d_pid": 1}


def ops_per_column(n_substeps, n_drones=1, euler_calls=1, pid=False,
                   routing=False):
    """Float32 operations of one column: mixer 30, one DYN substep 175
    (rotation 53, forces and torques 25, integration 27, exponential map
    55, ang-vel 15), one Euler extraction 40, task and select 40 per drone;
    `pid` adds one DSL-PID tick (325) and its setpoints (20) per drone;
    `routing` the pairwise separation (9 per unordered pair) and the
    nearest-neighbour scan (10 per ordered pair)."""
    per = 30 + 175 * n_substeps + 40 * euler_calls + 40
    if pid:
        per += 325 + 20
    ops = n_drones * per
    if routing:
        pairs = n_drones * (n_drones - 1)
        ops += 9 * pairs // 2 + 10 * pairs
    return ops


def pyb_ops_per_env(n_substeps, n, gnd, drag, dw, sweeps, n_spheres=0,
                    n_boxes=0, pid=False, euler_calls=1):
    """Float32 operations one env needs for a PYB-family control step.
    Per drone and substep: rotation 44, thrust and torques 55, velocity
    update 85, the 4 rim points' effective masses 364, one contact sweep
    532 (each point's normal impulse 45 and two tangent impulses of 44),
    position and quaternion 53, ground effect 167, drag 43, downwash 24 per
    other drone + 6, a sphere 15 and a box 40 to set up and 60 per sweep
    each.  Per unordered pair and substep 523, plus 56 per drone.  The
    solve runs every sweep whatever is in contact, so the count does not
    depend on the data.  Around it per drone: Euler extractions 40 each,
    task and select 40, the PID tick and setpoints 345."""
    n_obs = n_spheres + n_boxes
    per = 44 + 55 + 85 + 364 + 53 + sweeps * (532 + 60 * n_obs) \
        + 15 * n_spheres + 40 * n_boxes
    per += (167 if gnd else 0) + (43 if drag else 0)
    if dw and n > 1:
        per += 24 * (n - 1) + 6
    sub = n * per
    if n > 1:
        sub += 523 * n * (n - 1) // 2 + 56 * n
    return n_substeps * sub + n * (40 * euler_calls + 40
                                   + (345 if pid else 0))


def act_width(config: dict) -> int:
    """An env's action width: every drone's."""
    env = config["env"]
    return int(env["num_drones"]) * ACT_DIMS[env["task"]["act"]]


def obs_width(config: dict) -> int:
    """An env's observation width: per drone 12 kinematic values, the
    action ring of ctrl_freq / 2 actions, and routing's 6 extra values."""
    env = config["env"]
    a = ACT_DIMS[env["task"]["act"]]
    extra = 6 if env["task"]["kind"] == "routing" else 0
    return int(env["num_drones"]) * (12 + (int(env["ctrl_freq"]) // 2) * a
                                     + extra)


def env_step_work(config: dict) -> tuple:
    """(float32 operations, bytes) of one env's fused control step: every
    carry row the step needs read once (per drone 13 state rows, 16 under
    PYB, last-rpm in the drag modes, the PID rows, the ring without the
    rows it drops; the counter and the action rows), the whole carry and
    the outputs written once."""
    env = config["env"]
    n = int(env["num_drones"])
    physics = env["physics"]
    act = env["task"]["act"]
    a = ACT_DIMS[act]
    sub = int(env["pyb_freq"]) // int(env["ctrl_freq"])
    buf_rows = (int(env["ctrl_freq"]) // 2) * a
    pid = act in PID_ACTS
    routing = env["task"]["kind"] == "routing"
    pyb = physics != "dyn"
    n_extra = 6 if routing else 0
    carry_rows = n * (16 + 4 + (9 if pid else 0) + buf_rows) + 1
    out_rows = n * (12 + buf_rows + n_extra) + 3
    rows = n * ((16 if pyb else 13) + (4 if physics in DRAG_MODES else 0)
                + (9 if pid else 0) + buf_rows - a) + 1 \
        + n * a + carry_rows + out_rows
    ops = ops_per_column(sub, n, euler_calls=2, pid=pid, routing=routing)
    if pyb:
        ops += pyb_ops_per_env(
            sub, n, physics in GND_MODES, physics in DRAG_MODES,
            physics in DW_MODES, int(env.get("solver_iterations", 4))) \
            - n * (175 * sub + 30 + 40 + 40)
    return ops, rows * 4


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take for this work: the greater of
    its float32 operations over 67 TFLOP/s and its bytes over 3.35 TB/s."""
    return max(ops / FP32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)


def policy_flops(config: dict) -> tuple:
    """(forward FLOPs of one sample, forward and backward FLOPs of one
    sample) of the configuration's actor-critic: two tanh towers of the
    policy's widths from the observation, a mean head of the action width
    and a value head of 1; a multiply-add counts two, a bias add and a
    tanh one each; the backward pass twice the forward's products."""
    out = act_width(config) + 1                # the mean and the value
    widths = [obs_width(config)] + list(config["policy"]["hidden"])
    macs = sum(x * y for x, y in zip(widths[:-1], widths[1:]))
    elementwise = 2 * sum(widths[1:])        # bias add and tanh per unit
    tower = 2 * macs + elementwise
    fwd = 2 * tower + 2 * widths[-1] * out + out
    bwd_products = 2 * (2 * 2 * macs + 2 * widths[-1] * out)
    return fwd, fwd + bwd_products


def update_flops(config: dict, num_envs: int, rollout_steps: int) -> float:
    """FLOPs of one PPO update: the policy's forward pass on every rollout
    sample, its forward and backward pass on every sample of every epoch,
    and the env steps' physics operations."""
    fwd, fwd_bwd = policy_flops(config)
    samples = num_envs * rollout_steps
    epochs = int(config["ppo"]["update_epochs"])
    env_ops, _ = env_step_work(config)
    return samples * (fwd + epochs * fwd_bwd + env_ops)
