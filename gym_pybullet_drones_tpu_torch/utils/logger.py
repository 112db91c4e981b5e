"""Simulation logger: per-drone time series, .npy/CSV export, dashboard plot.

Own copy of the JAX package's `utils/logger.py`.  Parity target: the
reference's gym_pybullet_drones/utils/Logger.py —
same 16-channel state layout (pos, vel, rpy, ang_vel, 4 rpm; reordered from
the 20-dim obs exactly as reference Logger.log:117), same 12-channel control
targets, np.savez export (:123-127), per-channel CSV export including the
PWM conversion (rpm - 4070.3)/0.2685 (:131-201), and a 10x2 matplotlib grid
(:205-379).
"""
from __future__ import annotations

import os
from datetime import datetime

import numpy as np

from gym_pybullet_drones_tpu_torch.utils.utils import require

# CSV channel name -> row index in the 16-channel state matrix
_CSV_CHANNELS = {
    "x": 0, "y": 1, "z": 2,
    "vx": 3, "vy": 4, "vz": 5,
    "r": 6, "p": 7, "ya": 8,
    "wx": 9, "wy": 10, "wz": 11,
    "rpm0-": 12, "rpm1-": 13, "rpm2-": 14, "rpm3-": 15,
}


class Logger:
    """Stores and exports kinematic + control-target time series."""

    def __init__(self, logging_freq_hz: int, output_folder: str = "results",
                 num_drones: int = 1, duration_sec: int = 0,
                 colab: bool = False):
        self.COLAB = colab
        self.OUTPUT_FOLDER = output_folder
        os.makedirs(output_folder, exist_ok=True)
        self.LOGGING_FREQ_HZ = logging_freq_hz
        self.NUM_DRONES = num_drones
        self.PREALLOCATED_ARRAYS = duration_sec != 0
        n_steps = duration_sec * logging_freq_hz
        self.counters = np.zeros(num_drones, dtype=int)
        self.timestamps = np.zeros((num_drones, n_steps))
        self.states = np.zeros((num_drones, 16, n_steps))
        self.controls = np.zeros((num_drones, 12, n_steps))

    def log(self, drone: int, timestamp: float, state, control=None):
        """Record one step for one drone (state is the 20-dim vector)."""
        state = np.asarray(state)
        control = np.zeros(12) if control is None else np.asarray(control)
        if (drone < 0 or drone >= self.NUM_DRONES or timestamp < 0
                or len(state) != 20 or len(control) != 12):
            print("[ERROR] in Logger.log(), invalid data")
            return
        c = int(self.counters[drone])
        if c >= self.timestamps.shape[1]:
            self.timestamps = np.concatenate(
                [self.timestamps, np.zeros((self.NUM_DRONES, 1))], axis=1)
            self.states = np.concatenate(
                [self.states, np.zeros((self.NUM_DRONES, 16, 1))], axis=2)
            self.controls = np.concatenate(
                [self.controls, np.zeros((self.NUM_DRONES, 12, 1))], axis=2)
        elif not self.PREALLOCATED_ARRAYS and self.timestamps.shape[1] > c:
            c = self.timestamps.shape[1] - 1
        self.timestamps[drone, c] = timestamp
        # 20-dim obs -> 16-channel storage order (reference Logger.py:117)
        self.states[drone, :, c] = np.hstack(
            [state[0:3], state[10:13], state[7:10], state[13:20]])
        self.controls[drone, :, c] = control
        self.counters[drone] = c + 1

    def save(self) -> str:
        path = os.path.join(
            self.OUTPUT_FOLDER,
            "save-flight-" + datetime.now().strftime("%m.%d.%Y_%H.%M.%S")
            + ".npy")
        with open(path, "wb") as f:
            np.savez(f, timestamps=self.timestamps, states=self.states,
                     controls=self.controls)
        return path

    def save_as_csv(self, comment: str = "") -> str:
        csv_dir = os.path.join(
            self.OUTPUT_FOLDER, "save-flight-" + comment + "-"
            + datetime.now().strftime("%m.%d.%Y_%H.%M.%S"))
        os.makedirs(csv_dir, exist_ok=True)
        t = np.arange(self.timestamps.shape[1]) / self.LOGGING_FREQ_HZ
        for i in range(self.NUM_DRONES):
            for name, row in _CSV_CHANNELS.items():
                sep = "" if name.endswith("-") else ""
                path = os.path.join(csv_dir, f"{name}{sep}{i}.csv")
                np.savetxt(path, np.column_stack([t, self.states[i, row]]),
                           delimiter=",")
            # finite-difference rpy rates (reference :161-169)
            for name, row in (("rr", 6), ("pr", 7), ("yar", 8)):
                dot = np.hstack([0, np.diff(self.states[i, row])
                                 * self.LOGGING_FREQ_HZ])
                np.savetxt(os.path.join(csv_dir, f"{name}{i}.csv"),
                           np.column_stack([t, dot]), delimiter=",")
            # PWM conversions (reference :194-201)
            for k in range(4):
                pwm = (self.states[i, 12 + k] - 4070.3) / 0.2685
                np.savetxt(os.path.join(csv_dir, f"pwm{k}-{i}.csv"),
                           np.column_stack([t, pwm]), delimiter=",")
        return csv_dir

    def plot(self, pwm: bool = False):
        """10x2 grid of state channels vs time (reference Logger.py:205-379)."""
        matplotlib = require("matplotlib", "Logger.plot")
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        t = np.arange(self.timestamps.shape[1]) / self.LOGGING_FREQ_HZ
        fig, axs = plt.subplots(10, 2, figsize=(14, 20), sharex=True)
        labels_left = ["x (m)", "y (m)", "z (m)", "r (rad)", "p (rad)",
                       "y (rad)", "wx", "wy", "wz", "rpm0"]
        rows_left = [0, 1, 2, 6, 7, 8, 9, 10, 11, 12]
        labels_right = ["vx (m/s)", "vy (m/s)", "vz (m/s)", "rdot", "pdot",
                        "ydot", "rpm1", "rpm2", "rpm3", "pwm0"]
        for j in range(self.NUM_DRONES):
            for ax, lab, row in zip(axs[:, 0], labels_left, rows_left):
                ax.plot(t, self.states[j, row], label=f"drone_{j}")
                ax.set_ylabel(lab)
            rates = [np.hstack([0, np.diff(self.states[j, r])
                                * self.LOGGING_FREQ_HZ]) for r in (6, 7, 8)]
            right_series = [self.states[j, 3], self.states[j, 4],
                            self.states[j, 5], *rates, self.states[j, 13],
                            self.states[j, 14], self.states[j, 15],
                            (self.states[j, 12] - 4070.3) / 0.2685]
            for ax, lab, series in zip(axs[:, 1], labels_right, right_series):
                ax.plot(t, series, label=f"drone_{j}")
                ax.set_ylabel(lab)
        axs[-1, 0].set_xlabel("time (s)")
        axs[-1, 1].set_xlabel("time (s)")
        axs[0, 0].legend(loc="upper right", fontsize=7)
        fig.tight_layout()
        out = os.path.join(self.OUTPUT_FOLDER, "flight_plot.png")
        fig.savefig(out, dpi=110)
        plt.close(fig)
        return out
