#!/usr/bin/env python3
"""`sincosf` against `sinf` and `cosf`, bit for bit, at every float32 input.

    python3 scripts/sincos_identity.py [--out DIR]

Needs one CUDA card and nvcc.  The DYN kernels call `sincosf` where the
plain arithmetic reads a sine and a cosine of one angle (one argument
reduction instead of two); that keeps their results only if `sincosf`
gives the values `sinf` and `cosf` give.  This builds a small CUDA source
with the package's own nvcc flags, computes `sinf` and `cosf` in kernels
of their own (so the compiler cannot merge them) and `sincosf` in a third
for all 2^32 bit patterns, counts the inputs where either value differs
(two NaNs count as equal), and prints the count, then the card's name and
power limit.  Exits 1 if any input differs.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from gym_pybullet_drones_tpu_torch import _build  # noqa: E402

SOURCE = r"""
#include <cuda_runtime.h>
#include <math.h>

__global__ void sin_all(unsigned base, float* o) {
    const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
    o[i] = sinf(__uint_as_float(base + i));
}

__global__ void cos_all(unsigned base, float* o) {
    const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
    o[i] = cosf(__uint_as_float(base + i));
}

__device__ bool same(float a, float b) {
    return __float_as_uint(a) == __float_as_uint(b) || (isnan(a) && isnan(b));
}

__global__ void sincos_cmp(unsigned base, const float* s, const float* c,
                           unsigned long long* differ) {
    const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
    float s2, c2;
    sincosf(__uint_as_float(base + i), &s2, &c2);
    if (!same(s[i], s2) || !same(c[i], c2)) atomicAdd(differ, 1ull);
}

// Inputs where sincosf differs from sinf or cosf, or -1 on a CUDA error.
extern "C" long long count_differing(void) {
    const unsigned chunk = 1u << 28;
    float *s, *c;
    unsigned long long* differ;
    if (cudaMalloc(&s, chunk * 4ull) || cudaMalloc(&c, chunk * 4ull) ||
        cudaMalloc(&differ, 8) || cudaMemset(differ, 0, 8))
        return -1;
    for (unsigned long long base = 0; base < (1ull << 32); base += chunk) {
        sin_all<<<chunk / 256, 256>>>((unsigned)base, s);
        cos_all<<<chunk / 256, 256>>>((unsigned)base, c);
        sincos_cmp<<<chunk / 256, 256>>>((unsigned)base, s, c, differ);
    }
    unsigned long long n = 0;
    const bool bad = cudaMemcpy(&n, differ, 8, cudaMemcpyDeviceToHost) ||
                     cudaGetLastError();
    cudaFree(s);
    cudaFree(c);
    cudaFree(differ);
    return bad ? -1 : (long long)n;
}
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "sincos_identity"))
    args = ap.parse_args()
    import chip_smoke  # the card's name and power limit
    os.makedirs(args.out, exist_ok=True)
    src, lib = (os.path.join(args.out, f) for f in ("check.cu", "check.so"))
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(lib).count_differing
    fn.restype = ctypes.c_longlong
    n = fn()
    print(json.dumps({"inputs": 2 ** 32, "differing": n}), flush=True)
    print(chip_smoke.gpu_line(), flush=True)
    return 0 if n == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
