// Crazyflie firmware-loop oracle (C++, double precision).
//
// The PyTorch port's own copy of the JAX package's
// native/cf_firmware_oracle.cpp.
// Independent-in-language transcription of the firmware controller stack the
// reference consumes through pycffirmware (reference CFAviary.py:368-420,
// 613-652): the 2-pole Butterworth sensor LPF (filter.c lpf2pInit/
// lpf2pApply), the Mellinger trajectory controller (controller_mellinger.c),
// the PID cascade (controller_pid.c / attitude_pid_controller.c /
// position_controller_pid.c) and the X-formation power distribution +
// brushed-motor PWM curve (power_distribution_stock.c, motors.c).
//
// pycffirmware is not a dependency of this project, so this oracle plays its
// role: a from-the-C-sources implementation, structurally independent of
// the port's control/firmware.py and control/firmware_pid.py, bound via
// ctypes (native/firmware_oracle.py) and compared tick-for-tick in
// tests/test_torch_firmware_oracle.py over a full takeoff-goto-land command
// sequence.  Double precision so agreement with float64 controllers is at
// rounding-noise level.
//
// Built by native/__init__.py: g++ -O2 -shared -fPIC, into build/native/.
#include <cmath>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// filter.c: 2-pole Butterworth low-pass (direct form II)
// ---------------------------------------------------------------------------
typedef struct {
  double b0, b1, b2, a1, a2;
  double d1, d2;
} lpf2p_t;

void lpf2p_init(lpf2p_t* f, double sample_freq, double cutoff_freq) {
  double fr = sample_freq / cutoff_freq;
  double ohm = std::tan(M_PI / fr);
  double c = 1.0 + 2.0 * std::cos(M_PI / 4.0) * ohm + ohm * ohm;
  f->b0 = ohm * ohm / c;
  f->b1 = 2.0 * f->b0;
  f->b2 = f->b0;
  f->a1 = 2.0 * (ohm * ohm - 1.0) / c;
  f->a2 = (1.0 - 2.0 * std::cos(M_PI / 4.0) * ohm + ohm * ohm) / c;
  f->d1 = 0.0;
  f->d2 = 0.0;
}

double lpf2p_apply(lpf2p_t* f, double sample) {
  double d0 = sample - f->d1 * f->a1 - f->d2 * f->a2;
  double out = d0 * f->b0 + f->d1 * f->b1 + f->d2 * f->b2;
  f->d2 = f->d1;
  f->d1 = d0;
  return out;
}

// ---------------------------------------------------------------------------
// small vector helpers (match ops/quat.py conventions: quats are xyzw)
// ---------------------------------------------------------------------------
static void quat_to_mat(const double q_in[4], double m[3][3]) {
  double n = std::sqrt(q_in[0] * q_in[0] + q_in[1] * q_in[1] +
                       q_in[2] * q_in[2] + q_in[3] * q_in[3]);
  double x = q_in[0] / n, y = q_in[1] / n, z = q_in[2] / n, w = q_in[3] / n;
  double xx = x * x, yy = y * y, zz = z * z;
  double xy = x * y, xz = x * z, yz = y * z;
  double wx = w * x, wy = w * y, wz = w * z;
  m[0][0] = 1 - 2 * (yy + zz); m[0][1] = 2 * (xy - wz); m[0][2] = 2 * (xz + wy);
  m[1][0] = 2 * (xy + wz); m[1][1] = 1 - 2 * (xx + zz); m[1][2] = 2 * (yz - wx);
  m[2][0] = 2 * (xz - wy); m[2][1] = 2 * (yz + wx); m[2][2] = 1 - 2 * (xx + yy);
}

static double quat_yaw(const double q_in[4]) {
  double n = std::sqrt(q_in[0] * q_in[0] + q_in[1] * q_in[1] +
                       q_in[2] * q_in[2] + q_in[3] * q_in[3]);
  double x = q_in[0] / n, y = q_in[1] / n, z = q_in[2] / n, w = q_in[3] / n;
  return std::atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z));
}

static void cross3(const double a[3], const double b[3], double out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

static double norm3(const double a[3]) {
  return std::sqrt(a[0] * a[0] + a[1] * a[1] + a[2] * a[2]);
}

// ---------------------------------------------------------------------------
// controller_mellinger.c
// ---------------------------------------------------------------------------
static const double GRAVITY_MAGNITUDE = 9.81;
static const double VEHICLE_MASS = 0.032;
static const double MASS_THRUST = 132000.0;
static const double KP_XY = 0.4, KD_XY = 0.2, KI_XY = 0.05, I_RANGE_XY = 2.0;
static const double KP_Z = 1.25, KD_Z = 0.4, KI_Z = 0.05, I_RANGE_Z = 0.4;
static const double KR_XY = 70000.0, KW_XY = 20000.0, KI_M_XY = 0.0,
                    I_RANGE_M_XY = 1.0;
static const double KR_Z = 60000.0, KW_Z = 12000.0, KI_M_Z = 500.0,
                    I_RANGE_M_Z = 1500.0;
static const double KD_OMEGA_RP = 200.0;
static const double DEG2RAD_C = M_PI / 180.0;

typedef struct {
  double i_error_pos[3];
  double i_error_m[3];
  double prev_omega[2];  // roll, pitch gyro (rad/s)
} mellinger_state_t;

void mellinger_init(mellinger_state_t* st) {
  std::memset(st, 0, sizeof(*st));
}

// control_out = (thrust, roll, pitch, yaw) in control_t units.
void mellinger_tick(mellinger_state_t* st, const double sp_pos[3],
                    const double sp_vel[3], const double sp_acc[3],
                    const double sp_att_rate_deg[3], const double sp_quat[4],
                    const double pos[3], const double vel[3],
                    const double quat[4], const double gyro_deg[3], double dt,
                    double control_out[4]) {
  double r_error[3], v_error[3];
  for (int i = 0; i < 3; i++) {
    r_error[i] = sp_pos[i] - pos[i];
    v_error[i] = sp_vel[i] - vel[i];
  }
  double i_range[3] = {I_RANGE_XY, I_RANGE_XY, I_RANGE_Z};
  double kp[3] = {KP_XY, KP_XY, KP_Z};
  double kd[3] = {KD_XY, KD_XY, KD_Z};
  double ki[3] = {KI_XY, KI_XY, KI_Z};
  double i_pos[3];
  for (int i = 0; i < 3; i++) {
    i_pos[i] = st->i_error_pos[i] + r_error[i] * dt;
    if (i_pos[i] > i_range[i]) i_pos[i] = i_range[i];
    if (i_pos[i] < -i_range[i]) i_pos[i] = -i_range[i];
  }
  double target_thrust[3];
  for (int i = 0; i < 3; i++) {
    double g = (i == 2) ? GRAVITY_MAGNITUDE : 0.0;
    target_thrust[i] = VEHICLE_MASS * (sp_acc[i] + g) + kp[i] * r_error[i] +
                       kd[i] * v_error[i] + ki[i] * i_pos[i];
  }
  double desired_yaw = quat_yaw(sp_quat);

  double R[3][3];
  quat_to_mat(quat, R);
  double z_axis[3] = {R[0][2], R[1][2], R[2][2]};
  double current_thrust = target_thrust[0] * z_axis[0] +
                          target_thrust[1] * z_axis[1] +
                          target_thrust[2] * z_axis[2];
  double tn = norm3(target_thrust);
  double z_des[3] = {target_thrust[0] / tn, target_thrust[1] / tn,
                     target_thrust[2] / tn};
  double x_c[3] = {std::cos(desired_yaw), std::sin(desired_yaw), 0.0};
  double y_des[3];
  cross3(z_des, x_c, y_des);
  double yn = norm3(y_des);
  for (int i = 0; i < 3; i++) y_des[i] /= yn;
  double x_des[3];
  cross3(y_des, z_des, x_des);
  // R_des columns = x_des, y_des, z_des
  double Rd[3][3];
  for (int i = 0; i < 3; i++) {
    Rd[i][0] = x_des[i];
    Rd[i][1] = y_des[i];
    Rd[i][2] = z_des[i];
  }
  // eRM = Rd^T R - R^T Rd ; eR = 0.5 * vee (with legacy pitch sign flip)
  double A[3][3], B[3][3];
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++) {
      A[i][j] = Rd[0][i] * R[0][j] + Rd[1][i] * R[1][j] + Rd[2][i] * R[2][j];
      B[i][j] = R[0][i] * Rd[0][j] + R[1][i] * Rd[1][j] + R[2][i] * Rd[2][j];
    }
  double eRM[3][3];
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++) eRM[i][j] = A[i][j] - B[i][j];
  double eR[3] = {0.5 * eRM[2][1], -0.5 * eRM[0][2], 0.5 * eRM[1][0]};

  double gyro_rad[3], sp_rate_rad[3];
  for (int i = 0; i < 3; i++) {
    gyro_rad[i] = gyro_deg[i] * DEG2RAD_C;
    sp_rate_rad[i] = sp_att_rate_deg[i] * DEG2RAD_C;
  }
  double ew[3] = {sp_rate_rad[0] - gyro_rad[0], gyro_rad[1] - sp_rate_rad[1],
                  sp_rate_rad[2] - gyro_rad[2]};
  double err_d_roll = -(gyro_rad[0] - st->prev_omega[0]) / dt;
  double err_d_pitch = (gyro_rad[1] - st->prev_omega[1]) / dt;
  st->prev_omega[0] = gyro_rad[0];
  st->prev_omega[1] = gyro_rad[1];

  double i_range_m[3] = {I_RANGE_M_XY, I_RANGE_M_XY, I_RANGE_M_Z};
  double i_m[3];
  for (int i = 0; i < 3; i++) {
    i_m[i] = st->i_error_m[i] + (-eR[i]) * dt;
    if (i_m[i] > i_range_m[i]) i_m[i] = i_range_m[i];
    if (i_m[i] < -i_range_m[i]) i_m[i] = -i_range_m[i];
  }
  double mx = -KR_XY * eR[0] + KW_XY * ew[0] + KI_M_XY * i_m[0] +
              KD_OMEGA_RP * err_d_roll;
  double my = -KR_XY * eR[1] + KW_XY * ew[1] + KI_M_XY * i_m[1] +
              KD_OMEGA_RP * err_d_pitch;
  double mz = -KR_Z * eR[2] + KW_Z * ew[2] + KI_M_Z * i_m[2];

  double thrust = MASS_THRUST * current_thrust;
  int active = thrust > 0;
  double clip = 32000.0;
  control_out[0] = thrust;
  control_out[1] = active ? std::fmax(-clip, std::fmin(clip, mx)) : 0.0;
  control_out[2] = active ? std::fmax(-clip, std::fmin(clip, my)) : 0.0;
  control_out[3] = active ? std::fmax(-clip, std::fmin(clip, -mz)) : 0.0;
  for (int i = 0; i < 3; i++) {
    st->i_error_pos[i] = active ? i_pos[i] : 0.0;
    st->i_error_m[i] = active ? i_m[i] : 0.0;
  }
}

// ---------------------------------------------------------------------------
// controller_pid.c cascade (position 100 Hz + attitude/rate 500 Hz)
// ---------------------------------------------------------------------------
typedef struct {
  double integ, prev_e;
} pid1_t;

typedef struct {
  pid1_t vx, vy, vz;
  pid1_t att_roll, att_pitch, att_yaw;
  pid1_t rate_roll, rate_pitch, rate_yaw;
  double des_roll, des_pitch, thrust;
} fwpid_state_t;

void fwpid_init(fwpid_state_t* st) { std::memset(st, 0, sizeof(*st)); }

static double pid_run(pid1_t* p, double error, double dt, double kp,
                      double ki, double kd, double ilimit) {
  double integ = p->integ + error * dt;
  if (integ > ilimit) integ = ilimit;
  if (integ < -ilimit) integ = -ilimit;
  double deriv = (error - p->prev_e) / dt;
  p->integ = integ;
  p->prev_e = error;
  return kp * error + ki * integ + kd * deriv;
}

void fwpid_position(fwpid_state_t* st, double dt, const double pos[3],
                    const double vel[3], double yaw_deg,
                    const double target_pos[3]) {
  const double POS_KP = 2.0;
  double vsp[3];
  for (int i = 0; i < 3; i++) vsp[i] = POS_KP * (target_pos[i] - pos[i]);
  double raw_pitch = pid_run(&st->vx, vsp[0] - vel[0], dt, 25.0, 1.0, 0.0,
                             5000.0);
  double raw_roll = pid_run(&st->vy, vsp[1] - vel[1], dt, 25.0, 1.0, 0.0,
                            5000.0);
  double raw_thrust = pid_run(&st->vz, vsp[2] - vel[2], dt, 25.0, 15.0, 0.0,
                              5000.0);
  double yaw_rad = yaw_deg * DEG2RAD_C;
  double c = std::cos(yaw_rad), s = std::sin(yaw_rad);
  double pitch = raw_pitch * c + raw_roll * s;
  double roll = -raw_roll * c + raw_pitch * s;
  const double RP_LIMIT = 20.0;
  if (roll > RP_LIMIT) roll = RP_LIMIT;
  if (roll < -RP_LIMIT) roll = -RP_LIMIT;
  if (pitch > RP_LIMIT) pitch = RP_LIMIT;
  if (pitch < -RP_LIMIT) pitch = -RP_LIMIT;
  double thrust = raw_thrust * 1000.0 + 36000.0;
  if (thrust > 65535.0) thrust = 65535.0;
  if (thrust < 20000.0) thrust = 20000.0;
  st->des_roll = roll;
  st->des_pitch = pitch;
  st->thrust = thrust;
}

void fwpid_attitude(fwpid_state_t* st, double dt, const double rpy_deg[3],
                    const double gyro_deg[3], double target_yaw_deg,
                    double control_out[4]) {
  double yaw_e = target_yaw_deg - rpy_deg[2];
  yaw_e = std::fmod(yaw_e + 180.0, 360.0);
  if (yaw_e < 0) yaw_e += 360.0;  // match Python's non-negative modulo
  yaw_e -= 180.0;
  double rr_sp = pid_run(&st->att_roll, st->des_roll - rpy_deg[0], dt, 6.0,
                         3.0, 0.0, 20.0);
  double pr_sp = pid_run(&st->att_pitch, st->des_pitch - rpy_deg[1], dt, 6.0,
                         3.0, 0.0, 20.0);
  double yr_sp = pid_run(&st->att_yaw, yaw_e, dt, 6.0, 1.0, 0.35, 360.0);
  double cmd_roll = pid_run(&st->rate_roll, rr_sp - gyro_deg[0], dt, 250.0,
                            500.0, 2.5, 33.3);
  double cmd_pitch = pid_run(&st->rate_pitch, pr_sp - gyro_deg[1], dt, 250.0,
                             500.0, 2.5, 33.3);
  double cmd_yaw = pid_run(&st->rate_yaw, yr_sp - gyro_deg[2], dt, 120.0,
                           16.7, 0.0, 166.7);
  const double I16 = 32767.0;
  if (cmd_roll > I16) cmd_roll = I16;
  if (cmd_roll < -I16) cmd_roll = -I16;
  if (cmd_pitch > I16) cmd_pitch = I16;
  if (cmd_pitch < -I16) cmd_pitch = -I16;
  if (cmd_yaw > I16) cmd_yaw = I16;
  if (cmd_yaw < -I16) cmd_yaw = -I16;
  control_out[0] = st->thrust;
  control_out[1] = cmd_roll;
  control_out[2] = -cmd_pitch;  // legacy output frame (see firmware_pid.py)
  control_out[3] = -cmd_yaw;
}

// ---------------------------------------------------------------------------
// power_distribution_stock.c + motors.c brushed PWM curve
// ---------------------------------------------------------------------------
void power_distribution(const double control[4], int quad_formation_x,
                        double pwm_out[4]) {
  const double MAX_PWM = 65535.0, SUPPLY_VOLTAGE = 3.0;
  double thrust = control[0], roll = control[1], pitch = control[2],
         yaw = control[3];
  double m[4];
  if (quad_formation_x) {
    double r = roll / 2.0, p = pitch / 2.0;
    m[0] = thrust - r + p + yaw;
    m[1] = thrust - r - p - yaw;
    m[2] = thrust + r - p + yaw;
    m[3] = thrust + r + p - yaw;
  } else {
    m[0] = thrust + pitch + yaw;
    m[1] = thrust - roll - yaw;
    m[2] = thrust - pitch + yaw;
    m[3] = thrust + roll - yaw;
  }
  for (int i = 0; i < 4; i++) {
    if (m[i] > MAX_PWM) m[i] = MAX_PWM;
    if (m[i] < 0.0) m[i] = 0.0;
    double t = m[i] / 65536.0 * 60.0;
    double volts = -0.0006239 * t * t + 0.088 * t;
    double pct = volts / SUPPLY_VOLTAGE;
    if (pct > 1.0) pct = 1.0;
    pwm_out[i] = pct * MAX_PWM;
  }
}

}  // extern "C"
