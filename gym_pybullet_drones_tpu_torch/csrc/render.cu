// render: the analytic ray-tracing camera, several pixels a thread.
//
// The JAX package renders with one fused XLA program (its ops/render.py);
// there is no Pallas kernel behind it.  Written as eager PyTorch the same
// function is some 300 elementwise launches per frame, so on the card it is
// this one kernel, and ops/render.py is its plain version.
//
// Work: C cameras of W x H pixels.  Camera c sits at drone c of a flat
// (env x drone) batch and sees, besides the scene, the `group` drones of its
// env, rows (c / group) * group + j of the same position array.
//
// What bounds it on an H100: not the 16 bytes of rgba a pixel writes (3.35
// TB/s) but its float32 work, some 420 operations a pixel on the landmark
// scene (chip_smoke.py's `render_ops_per_pixel`), against 67 TFLOP/s, which
// counts an FMA as two.  The source is built without FMA contraction
// (_build.EXTRA_FLAGS), so that every product and sum is rounded as the
// plain version rounds it and the kernel is bit for bit ops/render.py on
// the card; a multiply-add is then two instructions, and each IEEE division
// and square root a reciprocal or root unit op, a Newton step and a branch
// to its slow path.  So the instructions a pixel issues bound it, and the
// design takes out every instruction that repeats work of the camera, of
// the row or column, or of a primitive that does not win, while keeping
// each float the plain version rounds (each expression evaluated once, in
// the same operand order):
//
// - Per-camera terms once per camera, into shared memory, by several
//   threads at once: thread 0 builds the basis; lanes of the second warp
//   each take one primitive: a sphere's (landmark or drone) o - centre and
//   |o - centre|^2 - r^2 (a drone within 3L of the camera has radius 0), a
//   box's slab numerators c -/+ half - o.  The plane's -o[2] with the basis.
// - The pixel offsets from two tables, one per column and one per row,
//   filled once per block; the ray's three slab reciprocals once a ray, for
//   every box.
// - The closest hit is its t and a tag (the primitive's index in the order
//   landmark spheres, drone spheres, boxes, plane; strict < so a tie goes
//   to the first); the normal, colour and checker are computed after the
//   loop, for the winner only, from the same t, eye, ray and centre.
// - Several pixels a thread (GPD_RENDER_PIXELS), GPD_RENDER_THREADS apart,
//   so each warp's float4 stores stay 32 consecutive pixels (full 128-byte
//   lines) and the pixels are independent chains the scheduler interleaves;
//   each primitive is tested for all of a thread's pixels before the next.
//   A block takes GPD_RENDER_THREADS x GPD_RENDER_PIXELS consecutive pixels
//   of one camera (blockIdx.y, strided over cameras beyond the grid); tail
//   pixels are computed on a clamped index and not stored.
//
// The rest of the card does not apply: there is no product for the tensor
// cores (wgmma), and the inputs are 7 floats a camera and the outputs
// already coalesced 16-byte stores, so no copy engine (TMA, cp.async) has
// anything to move.  The checkerboard's modulo is the floored one
// (-1 % 2 == 1), as torch's `remainder` and jnp's `%`.
#if defined(__CUDACC__)
#include <cuda_runtime.h>
#endif
#include <math.h>

#if defined(__CUDACC__)
#define GPD_RHD __host__ __device__ __forceinline__
#else
#define GPD_RHD inline
#endif

#define GPD_RENDER_THREADS 256
#define GPD_RENDER_PIXELS 4
#define GPD_RENDER_TILE (GPD_RENDER_THREADS * GPD_RENDER_PIXELS)
#define GPD_MAX_SPHERES 8
#define GPD_MAX_BOXES 8
#define GPD_RENDER_MAX_DRONES 8
#define GPD_RENDER_SPHERES (GPD_MAX_SPHERES + GPD_RENDER_MAX_DRONES)
#define GPD_BIG 1e9f

// the per-camera jobs (basis, every sphere, every box) fit the lanes of
// thread 0 and the second warp
static_assert(GPD_RENDER_THREADS >= 64
              && GPD_RENDER_THREADS % 32 == 0
              && GPD_RENDER_SPHERES + GPD_MAX_BOXES <= 32,
              "render: at least two warps a block");

// Every constant of one render configuration, each a float32 rounded once
// from double (mirrored by _build.RenderParams).
struct GpdRenderParams {
    int width, height;
    int group;        // drones (and cameras) per env: drone c's env holds
                      // rows (c / group) * group .. + group of the positions
    int n_spheres, n_boxes;
    float l;          // the eye's height above its drone, and the near plane
    float tan_half;   // tan(FOV / 2)
    float far, depth_scale;        // far plane, far / (far - near)
    float drone_r, drone_excl;     // drone sphere radius 2L; not drawn
                                   // within 3L of the camera
    float light[3];                // LIGHT_DIR normalised in float32
    float sky[3];
    float ambient, diffuse;
    float checker[2];              // plane grey, odd / even tile
    float drone_color[3];
    float sphere[GPD_MAX_SPHERES][4];      // centre xyz, radius
    float sphere_color[GPD_MAX_SPHERES][3];
    int sphere_id[GPD_MAX_SPHERES];
    float box_center[GPD_MAX_BOXES][3];
    float box_half[GPD_MAX_BOXES][3];
    float box_color[GPD_MAX_BOXES][3];
    int box_id[GPD_MAX_BOXES];
};

// What one camera's rays share (shared memory in the kernel).  Spheres are
// the landmark spheres, then the env's drones.
struct alignas(16) GpdRenderCam {
    float sph[GPD_RENDER_SPHERES][4];  // o - centre (xyz), |o - centre|^2 - r^2
    float cen[GPD_RENDER_SPHERES][4];  // centre (xyz), for the winner's normal
    float slab[GPD_MAX_BOXES][2][4];   // (c - half - o), (c + half - o) (xyz)
    float o[4], f[4], r[4], u[4];      // eye, forward, right, up (xyz)
    float neg_oz;                      // -o[2], the plane's numerator
};

GPD_RHD float gpd_rmax(float a, float b) { return a > b ? a : b; }
GPD_RHD float gpd_rmin(float a, float b) { return a < b ? a : b; }
GPD_RHD float gpd_clamp_lo(float x, float lo) { return x < lo ? lo : x; }
GPD_RHD float gpd_sign(float x) {
    return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// The image-plane offsets of pixel centres: column i of w, row j of h.
GPD_RHD float gpd_offset_x(int i, int w, float tan_half) {
    return (2.0f * ((float)i + 0.5f) / (float)w - 1.0f) * tan_half;
}
GPD_RHD float gpd_offset_y(int j, int h, float tan_half) {
    return (1.0f - 2.0f * ((float)j + 0.5f) / (float)h) * tan_half;
}

// The eye of a camera at `pos`.
GPD_RHD void gpd_eye(const GpdRenderParams& p, const float* pos, float* o) {
    o[0] = pos[0] + 0.0f;
    o[1] = pos[1] + 0.0f;
    o[2] = pos[2] + p.l;
}

// The camera of a drone at `pos` with attitude `q` (xyzw): the first column
// of the normalised quaternion's rotation is the view direction.
GPD_RHD void gpd_camera(const GpdRenderParams& p, const float* pos,
                        const float* q, GpdRenderCam& cam) {
    gpd_eye(p, pos, cam.o);
    cam.neg_oz = -cam.o[2];
    const float n = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2]
                          + q[3] * q[3]);
    const float x = q[0] / n, y = q[1] / n, z = q[2] / n, w = q[3] / n;
    const float f0 = 1.0f - 2.0f * (y * y + z * z);
    const float f1 = 2.0f * (x * y + w * z);
    const float f2 = 2.0f * (x * z - w * y);
    // right = forward x up, up = (0, 0, 1), floored at 1e-6 for a vertical
    // view; then the camera's up = right x forward
    const float u0 = 0.0f, u1 = 0.0f, u2 = 1.0f;
    float r0 = f1 * u2 - f2 * u1, r1 = f2 * u0 - f0 * u2,
          r2 = f0 * u1 - f1 * u0;
    const float rn = gpd_clamp_lo(sqrtf(r0 * r0 + r1 * r1 + r2 * r2), 1e-6f);
    r0 = r0 / rn; r1 = r1 / rn; r2 = r2 / rn;
    cam.f[0] = f0; cam.f[1] = f1; cam.f[2] = f2;
    cam.r[0] = r0; cam.r[1] = r1; cam.r[2] = r2;
    cam.u[0] = r1 * f2 - r2 * f1;
    cam.u[1] = r2 * f0 - r0 * f2;
    cam.u[2] = r0 * f1 - r1 * f0;
}

// A sphere's per-camera part: o - c and |o - c|^2 - r^2 into `sph`, the
// centre into `cen`.
GPD_RHD void gpd_sphere_cam(const float* o, float cx, float cy, float cz,
                            float r, float* sph, float* cen) {
    const float ocx = o[0] - cx, ocy = o[1] - cy, ocz = o[2] - cz;
    sph[0] = ocx; sph[1] = ocy; sph[2] = ocz;
    sph[3] = ocx * ocx + ocy * ocy + ocz * ocz - r * r;
    cen[0] = cx; cen[1] = cy; cen[2] = cz;
}

// A sphere's per-ray part: the distance along the unit ray d to the first
// hit beyond 1e-4, or GPD_BIG.
GPD_RHD float gpd_sphere_t(const float* sph, float d0, float d1, float d2) {
    const float b = sph[0] * d0 + sph[1] * d1 + sph[2] * d2;
    const float disc = b * b - sph[3];
    const float sq = sqrtf(gpd_clamp_lo(disc, 0.0f));
    const float t0 = -b - sq;
    const float t1 = -b + sq;
    const float t = t0 > 1e-4f ? t0 : t1;
    return (disc > 0.0f && t > 1e-4f) ? t : GPD_BIG;
}

// A box's per-camera part: the slab numerators c - half - o and
// c + half - o of each axis.
GPD_RHD void gpd_box_cam(const float* o, const float* c, const float* half,
                         float (*slab)[4]) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        slab[0][k] = c[k] - half[k] - o[k];
        slab[1][k] = c[k] + half[k] - o[k];
    }
}

// The reciprocal of one ray component for the slabs, its magnitude floored
// at 1e-9 with its sign kept.
GPD_RHD float gpd_slab_inv(float dk) {
    const float den = fabsf(dk) > 1e-9f ? dk : (dk >= 0.0f ? 1e-9f : -1e-9f);
    return 1.0f / den;
}

// Each axis' entry distance of the ray (reciprocals `inv`) into the box of
// slab numerators `slab`; returns the exit distance's minimum in *tmax.
GPD_RHD void gpd_slabs(const float (*slab)[4], const float* inv,
                       float* tmin_ax, float* tmax) {
    float tmax_ax[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float lo = slab[0][k] * inv[k];
        const float hi = slab[1][k] * inv[k];
        tmin_ax[k] = gpd_rmin(lo, hi);
        tmax_ax[k] = gpd_rmax(lo, hi);
    }
    *tmax = gpd_rmin(gpd_rmin(tmax_ax[0], tmax_ax[1]), tmax_ax[2]);
}

// A box's per-ray part: the entry distance (or the exit from inside), or
// GPD_BIG.
GPD_RHD float gpd_box_t(const float (*slab)[4], const float* inv) {
    float tmin_ax[3], tmax;
    gpd_slabs(slab, inv, tmin_ax, &tmax);
    const float tmin =
        gpd_rmax(gpd_rmax(tmin_ax[0], tmin_ax[1]), tmin_ax[2]);
    const bool hit = tmax > gpd_clamp_lo(tmin, 1e-4f);
    return hit ? (tmin > 1e-4f ? tmin : tmax) : GPD_BIG;
}

// Thread job `job` of camera c's per-camera terms: 0 the basis, then each
// landmark sphere, each of the env's drones, each box; any other job
// nothing.  Jobs write disjoint parts of `cam`.
GPD_RHD void gpd_camera_job(const GpdRenderParams& p, const float* pos,
                            int pos_s0, int pos_s1, const float* quat,
                            int quat_s0, int quat_s1, int c, int job,
                            GpdRenderCam& cam) {
    const float cp[3] = {pos[(size_t)c * pos_s0],
                         pos[(size_t)c * pos_s0 + pos_s1],
                         pos[(size_t)c * pos_s0 + 2 * pos_s1]};
    if (job == 0) {
        const float cq[4] = {quat[(size_t)c * quat_s0],
                             quat[(size_t)c * quat_s0 + quat_s1],
                             quat[(size_t)c * quat_s0 + 2 * quat_s1],
                             quat[(size_t)c * quat_s0 + 3 * quat_s1]};
        gpd_camera(p, cp, cq, cam);
        return;
    }
    float o[3];
    gpd_eye(p, cp, o);
    int s = job - 1;
    if (s < p.n_spheres) {
        gpd_sphere_cam(o, p.sphere[s][0], p.sphere[s][1], p.sphere[s][2],
                       p.sphere[s][3], cam.sph[s], cam.cen[s]);
        return;
    }
    const int m = s - p.n_spheres;
    if (m < p.group) {
        const size_t row = (size_t)(c / p.group) * p.group + m;
        const float dx = pos[row * pos_s0], dy = pos[row * pos_s0 + pos_s1],
                    dz = pos[row * pos_s0 + 2 * pos_s1];
        const float ex = dx - cp[0], ey = dy - cp[1], ez = dz - cp[2];
        const float dist = sqrtf(ex * ex + ey * ey + ez * ez);
        const float r = dist < p.drone_excl ? 0.0f : p.drone_r;
        gpd_sphere_cam(o, dx, dy, dz, r, cam.sph[s], cam.cen[s]);
        return;
    }
    const int b = m - p.group;
    if (b < p.n_boxes) gpd_box_cam(o, p.box_center[b], p.box_half[b],
                                   cam.slab[b]);
}

// The GPD_RENDER_PIXELS pixels first, first + GPD_RENDER_THREADS, ... of
// one camera (those at npix or beyond are computed on the last pixel and
// are the caller's to drop): rgba, depth buffer, seg id.  `tab` holds the
// column offsets (width floats), then the row offsets (height floats).
GPD_RHD void gpd_render_pixels(const GpdRenderParams& p,
                               const GpdRenderCam& cam, const float* tab,
                               int first, int npix,
                               float (*rgba)[4], float* depth, int* seg) {
    constexpr int P = GPD_RENDER_PIXELS;
    const int w = p.width;
    const int nsph = p.n_spheres + p.group;
    const int plane = nsph + p.n_boxes;   // the plane's tag
    float d[P][3], inv[P][3], tb[P];
    int win[P];
    int col = first % w, row = first / w;
    const int step_col = GPD_RENDER_THREADS % w,
              step_row = GPD_RENDER_THREADS / w;
#pragma unroll
    for (int k = 0; k < P; ++k) {
        const int pix = first + k * GPD_RENDER_THREADS;
        // the tail's rows lie beyond the table: their last pixel's ray
        const int i = pix < npix ? col : w - 1;
        const int j = pix < npix ? row : p.height - 1;
        const float px = tab[i], py = tab[w + j];
#pragma unroll
        for (int a = 0; a < 3; ++a)
            d[k][a] = cam.f[a] + px * cam.r[a] + py * cam.u[a];
        const float inv_len = 1.0f / sqrtf(d[k][0] * d[k][0]
                                           + d[k][1] * d[k][1]
                                           + d[k][2] * d[k][2]);
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            d[k][a] = d[k][a] * inv_len;
            inv[k][a] = gpd_slab_inv(d[k][a]);
        }
        tb[k] = GPD_BIG;
        win[k] = -1;
        col += step_col;
        row += step_row;
        if (col >= w) { col -= w; ++row; }
    }
#pragma unroll 1
    for (int s = 0; s < nsph; ++s) {
        const float sph[4] = {cam.sph[s][0], cam.sph[s][1], cam.sph[s][2],
                              cam.sph[s][3]};
#pragma unroll
        for (int k = 0; k < P; ++k) {
            const float t = gpd_sphere_t(sph, d[k][0], d[k][1], d[k][2]);
            if (t < tb[k]) { tb[k] = t; win[k] = s; }
        }
    }
#pragma unroll 1
    for (int b = 0; b < p.n_boxes; ++b) {
        float slab[2][4];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            slab[0][a] = cam.slab[b][0][a];
            slab[1][a] = cam.slab[b][1][a];
        }
#pragma unroll
        for (int k = 0; k < P; ++k) {
            const float t = gpd_box_t(slab, inv[k]);
            if (t < tb[k]) { tb[k] = t; win[k] = nsph + b; }
        }
    }
    // ground plane z = 0
#pragma unroll
    for (int k = 0; k < P; ++k) {
        float tp = fabsf(d[k][2]) > 1e-6f ? cam.neg_oz / d[k][2] : GPD_BIG;
        tp = tp > 1e-4f ? tp : GPD_BIG;
        if (tp < tb[k]) { tb[k] = tp; win[k] = plane; }
    }

    // the winner's normal and colour, for a hit nearer than the far plane
    // (else the sky, whatever won)
#pragma unroll
    for (int k = 0; k < P; ++k) {
        const float t = tb[k];
        const int wk = win[k];
        const bool hit = t < p.far;
        float nx = 0.0f, ny = 0.0f, nz = 0.0f;
        float base[3] = {p.sky[0], p.sky[1], p.sky[2]};
        int id = -1;
        if (hit) {
            float col3[3];
            if (wk < nsph) {
                const float* cc = cam.cen[wk];
                const float hx = cam.o[0] + t * d[k][0] - cc[0];
                const float hy = cam.o[1] + t * d[k][1] - cc[1];
                const float hz = cam.o[2] + t * d[k][2] - cc[2];
                const float inv_n = 1.0f / gpd_clamp_lo(
                    sqrtf(hx * hx + hy * hy + hz * hz), 1e-9f);
                nx = hx * inv_n; ny = hy * inv_n; nz = hz * inv_n;
                if (wk < p.n_spheres) {
#pragma unroll
                    for (int a = 0; a < 3; ++a)
                        col3[a] = p.sphere_color[wk][a];
                    id = p.sphere_id[wk];
                } else {
#pragma unroll
                    for (int a = 0; a < 3; ++a) col3[a] = p.drone_color[a];
                    id = 100 + (wk - p.n_spheres);
                }
            } else if (wk < plane) {
                // the axis of entry (first maximum); sign(0) is 0
                const int b = wk - nsph;
                float tmin_ax[3], tmax;
                gpd_slabs(cam.slab[b], inv[k], tmin_ax, &tmax);
                const float tx = tmin_ax[0], ty = tmin_ax[1],
                            tz = tmin_ax[2];
                const bool is_x = (tx >= ty) && (tx >= tz);
                const bool is_y = !is_x && (ty >= tz);
                nx = is_x ? -gpd_sign(d[k][0]) : 0.0f;
                ny = is_y ? -gpd_sign(d[k][1]) : 0.0f;
                nz = (is_x || is_y) ? 0.0f : -gpd_sign(d[k][2]);
#pragma unroll
                for (int a = 0; a < 3; ++a) col3[a] = p.box_color[b][a];
                id = p.box_id[b];
            } else {
                // a checkerboard of the floored modulo
                const float hpx = cam.o[0] + t * d[k][0],
                            hpy = cam.o[1] + t * d[k][1];
                const float s = floorf(hpx) + floorf(hpy);
                const float checker = s - 2.0f * floorf(s * 0.5f);
                const float pc = checker > 0.5f ? p.checker[0] : p.checker[1];
                nz = 1.0f;
                col3[0] = pc; col3[1] = pc; col3[2] = pc;
                id = 0;
            }
            const float lam = gpd_clamp_lo(
                nx * p.light[0] + ny * p.light[1] + nz * p.light[2], 0.0f);
            const float shade = p.ambient + p.diffuse * lam;
#pragma unroll
            for (int a = 0; a < 3; ++a) base[a] = shade * col3[a];
        }
        seg[k] = id;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            const float v = base[a] * 255.0f;
            rgba[k][a] = gpd_rmin(gpd_clamp_lo(v, 0.0f), 255.0f);
        }
        rgba[k][3] = 255.0f;
        const float z = gpd_rmin(gpd_clamp_lo(t, p.l), p.far);
        depth[k] = p.depth_scale * (1.0f - p.l / z);
    }
}

#if defined(__CUDACC__)
__global__ void __launch_bounds__(GPD_RENDER_THREADS)
render_kernel(const float* __restrict__ pos, int pos_s0, int pos_s1,
              const float* __restrict__ quat, int quat_s0, int quat_s1,
              float* __restrict__ rgba, int ld, float* __restrict__ depth,
              int* __restrict__ seg, int C,
              const __grid_constant__ GpdRenderParams p) {
    __shared__ GpdRenderCam cam;
    extern __shared__ float tab[];  // column offsets, then row offsets
    const int tid = threadIdx.x;
    for (int x = tid; x < p.width + p.height; x += GPD_RENDER_THREADS)
        tab[x] = x < p.width ? gpd_offset_x(x, p.width, p.tan_half)
                             : gpd_offset_y(x - p.width, p.height,
                                            p.tan_half);
    const int npix = p.width * p.height;
    const int first = blockIdx.x * GPD_RENDER_TILE + tid;
    // the basis on thread 0; each sphere and box on a lane of warp 1
    const int job = tid == 0 ? 0 : (tid >= 32 ? tid - 31 : -1);
    const bool has_job =
        job >= 0 && job <= p.n_spheres + p.group + p.n_boxes;
    for (int c = blockIdx.y; c < C; c += gridDim.y) {
        __syncthreads();  // the previous camera's readers are done
        if (has_job)
            gpd_camera_job(p, pos, pos_s0, pos_s1, quat, quat_s0, quat_s1, c,
                           job, cam);
        __syncthreads();
        float out[GPD_RENDER_PIXELS][4], dep[GPD_RENDER_PIXELS];
        int sg[GPD_RENDER_PIXELS];
        gpd_render_pixels(p, cam, tab, first, npix, out, dep, sg);
        float4* row = reinterpret_cast<float4*>(rgba + (size_t)c * ld);
#pragma unroll
        for (int k = 0; k < GPD_RENDER_PIXELS; ++k) {
            const int pix = first + k * GPD_RENDER_THREADS;
            if (pix < npix) {
                row[pix] = make_float4(out[k][0], out[k][1], out[k][2],
                                       out[k][3]);
                if (depth != nullptr) depth[(size_t)c * npix + pix] = dep[k];
                if (seg != nullptr) seg[(size_t)c * npix + pix] = sg[k];
            }
        }
    }
}
#endif

extern "C" int gpd_params_size() { return (int)sizeof(GpdRenderParams); }

// Blocks (in all) and threads per block of the launch gpd_render makes for
// C cameras of `npix` pixels: ceil(npix / GPD_RENDER_TILE) blocks of pixels
// for each of min(C, 65535) cameras at once.
extern "C" void gpd_render_geometry(int C, int npix, int* blocks,
                                    int* threads) {
    *threads = GPD_RENDER_THREADS;
    const int cams = C < 65535 ? C : 65535;
    *blocks = (npix + GPD_RENDER_TILE - 1) / GPD_RENDER_TILE * cams;
}

#if defined(__CUDACC__)
// Launches on `stream`, does not synchronise, allocates nothing.  pos (C, 3)
// and quat (C, 4) are read through their element strides (camera, then
// component); rgba is C rows of `ld` floats, 16-byte aligned, the first
// W*H*4 of each written.  `depth` and `seg` ((C, H, W), contiguous) may be
// NULL.  Returns cudaGetLastError(); an image of more than 12288 rows and
// columns together (the offset tables beyond 48 KB) is refused.
extern "C" int gpd_render(const float* pos, int pos_s0, int pos_s1,
                          const float* quat, int quat_s0, int quat_s1,
                          float* rgba, int ld, float* depth, int* seg, int C,
                          const GpdRenderParams* p, void* stream) {
    if (C <= 0) return 0;
    const size_t tab_bytes = sizeof(float) * (p->width + p->height);
    if (tab_bytes > 48 * 1024) return (int)cudaErrorInvalidValue;
    const int npix = p->width * p->height;
    const dim3 grid((npix + GPD_RENDER_TILE - 1) / GPD_RENDER_TILE,
                    C < 65535 ? C : 65535);
    render_kernel<<<grid, GPD_RENDER_THREADS, tab_bytes,
                    (cudaStream_t)stream>>>(
        pos, pos_s0, pos_s1, quat, quat_s0, quat_s1, rgba, ld, depth, seg, C,
        *p);
    return (int)cudaGetLastError();
}
#endif
