// Explicit quadrotor dynamics oracle — native C++ implementation.
//
// The PyTorch port's own copy of the JAX package's
// native/dynamics_oracle.cpp.
// Third, independent implementation of the DYN physics contract
// (reference gym_pybullet_drones/envs/BaseAviary.py:815-889; see also
// ops/dynamics.py and tests/_oracle.py) used to cross-verify the JAX
// kernel at double precision from outside the Python/XLA stack — the role
// the reference delegates to PyBullet's C++ core.  Exposed through a plain
// C ABI for ctypes.
//
// Built by native/__init__.py: g++ -O2 -shared -fPIC, into build/native/.

#include <cmath>
#include <cstring>

namespace {

struct Params {
  double m, l, kf, km;
  double ixx, iyy, izz;
  int model;  // 0 = cf2x, 1 = cf2p, 2 = racer
};

inline void quat_to_mat(const double q[4], double R[9]) {
  double n = std::sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  double x = q[0] / n, y = q[1] / n, z = q[2] / n, w = q[3] / n;
  R[0] = 1 - 2 * (y * y + z * z);
  R[1] = 2 * (x * y - w * z);
  R[2] = 2 * (x * z + w * y);
  R[3] = 2 * (x * y + w * z);
  R[4] = 1 - 2 * (x * x + z * z);
  R[5] = 2 * (y * z - w * x);
  R[6] = 2 * (x * z - w * y);
  R[7] = 2 * (y * z + w * x);
  R[8] = 1 - 2 * (x * x + y * y);
}

inline void integrate_q(double q[4], const double w[3], double dt) {
  double p = w[0], qq = w[1], r = w[2];
  double norm = std::sqrt(p * p + qq * qq + r * r);
  if (norm <= 1e-8) return;  // np.isclose(norm, 0) branch
  double theta = norm * dt / 2;
  double c = std::cos(theta);
  double s = 2.0 / norm * std::sin(theta) * 0.5;
  double x = q[0], y = q[1], z = q[2], ww = q[3];
  q[0] = c * x + s * (r * y - qq * z + p * ww);
  q[1] = c * y + s * (-r * x + p * z + qq * ww);
  q[2] = c * z + s * (qq * x - p * y + r * ww);
  q[3] = c * ww + s * (-p * x - qq * y - r * z);
}

void dyn_substep(const Params& P, double pos[3], double quat[4],
                 double vel[3], double rates[3], double ang_v[3],
                 const double rpm[4], double dt) {
  double R[9];
  quat_to_mat(quat, R);
  double f[4], zt[4];
  for (int i = 0; i < 4; ++i) {
    f[i] = rpm[i] * rpm[i] * P.kf;
    zt[i] = rpm[i] * rpm[i] * P.km;
    if (P.model == 2) zt[i] = -zt[i];
  }
  double thrust = f[0] + f[1] + f[2] + f[3];
  double force[3] = {R[2] * thrust, R[5] * thrust,
                     R[8] * thrust - 9.8 * P.m};
  double z_torque = -zt[0] + zt[1] - zt[2] + zt[3];
  double x_torque, y_torque;
  if (P.model == 1) {  // cf2p
    x_torque = (f[1] - f[3]) * P.l;
    y_torque = (-f[0] + f[2]) * P.l;
  } else {  // cf2x / racer
    double arm = P.l / std::sqrt(2.0);
    x_torque = (f[0] + f[1] - f[2] - f[3]) * arm;
    y_torque = (-f[0] + f[1] + f[2] - f[3]) * arm;
  }
  // tau -= w x (J w), J diagonal
  double Jw[3] = {P.ixx * rates[0], P.iyy * rates[1], P.izz * rates[2]};
  double tau[3] = {
      x_torque - (rates[1] * Jw[2] - rates[2] * Jw[1]),
      y_torque - (rates[2] * Jw[0] - rates[0] * Jw[2]),
      z_torque - (rates[0] * Jw[1] - rates[1] * Jw[0])};
  double deriv[3] = {tau[0] * (1.0 / P.ixx), tau[1] * (1.0 / P.iyy),
                     tau[2] * (1.0 / P.izz)};
  for (int i = 0; i < 3; ++i) {
    vel[i] += dt * force[i] / P.m;
    rates[i] += dt * deriv[i];
  }
  for (int i = 0; i < 3; ++i) pos[i] += dt * vel[i];
  integrate_q(quat, rates, dt);
  // stored world angular velocity uses the PRE-step rotation
  for (int i = 0; i < 3; ++i)
    ang_v[i] = R[3 * i] * rates[0] + R[3 * i + 1] * rates[1] +
               R[3 * i + 2] * rates[2];
}

}  // namespace

extern "C" {

// Roll out T substeps for B independent drones.
// params: [m, l, kf, km, ixx, iyy, izz] ; model: 0 cf2x / 1 cf2p / 2 racer
// state arrays are (B, dim) row-major and updated in place;
// rpms is (T, B, 4); if traj_out != nullptr it receives (T, B, 3) positions.
void dyn_rollout(const double* params, int model, int B, int T, double dt,
                 double* pos, double* quat, double* vel, double* rates,
                 double* ang_v, const double* rpms, double* traj_out) {
  Params P;
  P.m = params[0];
  P.l = params[1];
  P.kf = params[2];
  P.km = params[3];
  P.ixx = params[4];
  P.iyy = params[5];
  P.izz = params[6];
  P.model = model;
  for (int t = 0; t < T; ++t) {
    for (int b = 0; b < B; ++b) {
      dyn_substep(P, pos + 3 * b, quat + 4 * b, vel + 3 * b, rates + 3 * b,
                  ang_v + 3 * b, rpms + 4 * (t * B + b), dt);
      if (traj_out)
        std::memcpy(traj_out + 3 * (t * B + b), pos + 3 * b,
                    3 * sizeof(double));
    }
  }
}

}  // extern "C"
