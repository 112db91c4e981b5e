// Betaflight SITL UDP bridge shim — native C++ implementation.
//
// The PyTorch port's own copy of the JAX package's native/sitl_bridge.cpp.
// High-rate counterpart of the Python socket loop in envs/beta_aviary.py
// (reference envs/BetaAviary.py:97-170): packs/sends the FDM state packet,
// packs/sends the RC packet, and polls the PWM socket, all in one C call
// per drone per control tick — removing per-packet Python overhead at the
// 500 Hz SITL rates.  Plain C ABI for ctypes.
//
// Built by native/__init__.py: g++ -O2 -shared -fPIC, into build/native/.

#include <arpa/inet.h>
#include <cstring>
#include <fcntl.h>
#include <sys/socket.h>
#include <unistd.h>

namespace {
constexpr int BASE_PORT_PWM = 9002;
constexpr int BASE_PORT_STATE = 9003;
constexpr int BASE_PORT_RC = 9004;

struct Bridge {
  int sock_out;   // send FDM + RC
  int sock_pwm;   // receive PWM (non-blocking)
  sockaddr_in addr_state;
  sockaddr_in addr_rc;
};
}  // namespace

extern "C" {

// Create a bridge for drone index `idx` bound to host `ip` (dotted quad).
// Returns an opaque handle (heap pointer) or 0 on failure.
void* sitl_bridge_create(const char* ip, int idx) {
  Bridge* b = new Bridge();
  b->sock_out = socket(AF_INET, SOCK_DGRAM, 0);
  b->sock_pwm = socket(AF_INET, SOCK_DGRAM, 0);
  if (b->sock_out < 0 || b->sock_pwm < 0) { delete b; return nullptr; }

  sockaddr_in bind_addr{};
  bind_addr.sin_family = AF_INET;
  bind_addr.sin_port = htons(BASE_PORT_PWM + 10 * idx);
  inet_pton(AF_INET, ip, &bind_addr.sin_addr);
  if (bind(b->sock_pwm, (sockaddr*)&bind_addr, sizeof(bind_addr)) < 0) {
    close(b->sock_out); close(b->sock_pwm); delete b; return nullptr;
  }
  fcntl(b->sock_pwm, F_SETFL, O_NONBLOCK);

  b->addr_state = sockaddr_in{};
  b->addr_state.sin_family = AF_INET;
  b->addr_state.sin_port = htons(BASE_PORT_STATE + 10 * idx);
  inet_pton(AF_INET, ip, &b->addr_state.sin_addr);
  b->addr_rc = b->addr_state;
  b->addr_rc.sin_port = htons(BASE_PORT_RC + 10 * idx);
  return b;
}

// One control tick: send FDM state (t + body rates, ENU->NED flips applied
// by caller) and RC channels; poll for a 4-float PWM packet into pwm_out.
// Returns 1 if fresh PWMs were received, 0 if stale, -1 on error.
int sitl_bridge_tick(void* handle, double t, const double* w_body,
                     const unsigned short* rc16, float* pwm_out) {
  Bridge* b = static_cast<Bridge*>(handle);
  if (!b) return -1;

  // FDM packet: '@dddddddddddddddddd' (reference :126-137)
  double fdm[18] = {0};
  fdm[0] = t;
  fdm[1] = w_body[0];
  fdm[2] = -w_body[1];
  fdm[3] = -w_body[2];
  fdm[7] = 1.0;   // unit quaternion w
  fdm[17] = 1.0;  // pressure
  sendto(b->sock_out, fdm, sizeof(fdm), 0,
         (sockaddr*)&b->addr_state, sizeof(b->addr_state));

  // RC packet: '@dHHHHHHHHHHHHHHHH' (reference :150-159); note the struct
  // layout has no padding between the double and the 16 uint16s with
  // native alignment on x86-64 (offset 8).
  unsigned char rc_packet[8 + 16 * 2];
  std::memcpy(rc_packet, &t, 8);
  std::memcpy(rc_packet + 8, rc16, 16 * 2);
  sendto(b->sock_out, rc_packet, sizeof(rc_packet), 0,
         (sockaddr*)&b->addr_rc, sizeof(b->addr_rc));

  float pwm[4];
  ssize_t n = recv(b->sock_pwm, pwm, sizeof(pwm), 0);
  if (n == sizeof(pwm)) {
    std::memcpy(pwm_out, pwm, sizeof(pwm));
    return 1;
  }
  return 0;
}

void sitl_bridge_destroy(void* handle) {
  Bridge* b = static_cast<Bridge*>(handle);
  if (!b) return;
  close(b->sock_out);
  close(b->sock_pwm);
  delete b;
}

}  // extern "C"
