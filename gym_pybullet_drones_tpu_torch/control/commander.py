"""High-level commander: polynomial trajectory planner (takeoff/land/goto).

Reimplements the crtpCommanderHighLevel planner surface consumed by the
reference CFAviary (reference envs/CFAviary.py:422-606; the firmware's
crtp_commander_high_level.c + planner.c): maneuvers are 7th-order
polynomials per axis with zero velocity/acceleration/jerk at both endpoints
("no-jerk" plans), evaluated for position/velocity/acceleration/yaw at the
firmware rate.  Host-side numpy: command arrival is inherently host-driven
and aperiodic, so this is planner logic, not a device kernel.

The PyTorch port's own copy of the JAX package's `control/commander.py`
(numpy only there too), line for line: the port imports nothing of the
JAX package.
"""
from __future__ import annotations

import numpy as np

# 7th-order "no-jerk" interpolation s(u): s(0)=0, s(1)=1 and zero 1st/2nd/3rd
# derivatives at both ends: s(u) = 35u^4 - 84u^5 + 70u^6 - 20u^7
_S_COEF = np.array([0, 0, 0, 0, 35.0, -84.0, 70.0, -20.0])
_DS_COEF = np.polynomial.polynomial.polyder(_S_COEF)
_D2S_COEF = np.polynomial.polynomial.polyder(_S_COEF, 2)


def _smooth(u: float):
    u = float(np.clip(u, 0.0, 1.0))
    s = np.polynomial.polynomial.polyval(u, _S_COEF)
    ds = np.polynomial.polynomial.polyval(u, _DS_COEF)
    d2s = np.polynomial.polynomial.polyval(u, _D2S_COEF)
    return s, ds, d2s


class HighLevelCommander:
    """Minimal planner with the firmware's command surface.

    All times are absolute simulation seconds (the caller supplies
    update_time(t) like crtpCommanderHighLevelUpdateTime).
    """

    def __init__(self):
        self.reset()

    def reset(self):
        self._t = 0.0
        self._plan = None  # (t0, duration, p0, p1, yaw0, yaw1)
        self._hover_pos = np.zeros(3)
        self._hover_yaw = 0.0

    # -- state feed ------------------------------------------------------
    def tell_state(self, pos, yaw: float):
        """crtpCommanderHighLevelTellState: record the current pose.

        planner.c starts every maneuver from the most recently TOLD state
        (not a stale latch), and while no plan is active the hover target
        tracks the told pose.
        """
        self._hover_pos = np.asarray(pos, float).copy()
        self._hover_yaw = float(yaw)

    def update_time(self, t: float):
        self._t = float(t)

    # -- commands --------------------------------------------------------
    def takeoff(self, height: float, duration: float, yaw: float | None = None):
        p0, y0 = self._origin()
        p1 = p0.copy()
        p1[2] = height
        self._start_plan(p1, y0 if yaw is None else yaw, duration)

    def takeoff_with_velocity(self, height: float, vel: float,
                              relative: bool):
        p0, y0 = self._origin()
        target_z = (p0[2] + height) if relative else height
        duration = max(abs(target_z - p0[2]) / max(vel, 1e-6), 0.2)
        p1 = p0.copy()
        p1[2] = target_z
        self._start_plan(p1, y0, duration)

    def land(self, height: float, duration: float, yaw: float | None = None):
        p0, y0 = self._origin()
        p1 = p0.copy()
        p1[2] = height
        self._start_plan(p1, y0 if yaw is None else yaw, duration)

    def land_with_velocity(self, height: float, vel: float, relative: bool):
        self.takeoff_with_velocity(height, vel, relative)

    def go_to(self, x: float, y: float, z: float, yaw: float,
              duration: float, relative: bool):
        p0, y0 = self._origin()
        p1 = np.array([x, y, z], float)
        if relative:
            p1 = p0 + p1
            yaw = y0 + yaw
        self._start_plan(p1, yaw, duration)

    def stop(self):
        self._plan = None

    def _origin(self):
        """Maneuver start pose: the current plan evaluation when one is
        active (planner.c continues from plan_current_goal), else the most
        recently told state."""
        if self._plan is not None:
            pos, _, _, yaw = self.get_setpoint()
            return np.asarray(pos, float), float(yaw)
        return self._hover_pos.copy(), self._hover_yaw

    def _start_plan(self, p1, yaw1: float, duration: float):
        p0, y0 = self._origin()
        self._plan = (self._t, max(float(duration), 1e-3),
                      p0, np.asarray(p1, float), y0, float(yaw1))

    # -- evaluation ------------------------------------------------------
    def get_setpoint(self):
        """(pos, vel, acc, yaw) at the current commander time."""
        if self._plan is None:
            return (self._hover_pos.copy(), np.zeros(3), np.zeros(3),
                    self._hover_yaw)
        t0, T, p0, p1, y0, y1 = self._plan
        u = (self._t - t0) / T
        if u >= 1.0:
            # maneuver complete: hold the endpoint (planner.c keeps the
            # finished plan active as a hover at its final point until
            # stop() or a new command)
            return p1.copy(), np.zeros(3), np.zeros(3), y1
        s, ds, d2s = _smooth(u)
        pos = p0 + (p1 - p0) * s
        vel = (p1 - p0) * ds / T
        acc = (p1 - p0) * d2s / (T * T)
        yaw = y0 + (y1 - y0) * s
        return pos, vel, acc, yaw

    @property
    def is_flying(self) -> bool:
        return self._plan is not None
