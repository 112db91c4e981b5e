// render: the analytic ray-tracing camera, one thread per pixel.
//
// The JAX package renders with one fused XLA program (its ops/render.py);
// there is no Pallas kernel behind it.  Written as eager PyTorch the same
// function is some 300 elementwise launches per frame, so on the card it is
// this one kernel, and ops/render.py is its plain version.
//
// Work: C cameras of W x H pixels.  Camera c sits at drone c of a flat
// (env x drone) batch and sees, besides the scene, the `group` drones of its
// env, rows (c / group) * group + j of the same position array.  A
// block of GPD_RENDER_THREADS threads takes GPD_RENDER_THREADS consecutive
// pixels of one camera (blockIdx.y, strided over cameras beyond the grid);
// thread 0 builds the camera's basis and the first threads load its env's
// drones (radius 0 within 3L of the camera) into shared memory once.  Each
// thread then intersects its ray with every primitive in the plain
// version's order (landmark spheres, drone spheres, boxes, plane), keeps
// the closest hit with strict < (the first primitive wins a tie), shades
// it, and writes its rgba as one float4 into the (C, ld) observation rows
// in HWC order; depth (float32) and seg (int32) only when asked.  Tail
// pixels are masked.
//
// The arithmetic is the plain version's, operation for operation, and this
// source is built without FMA contraction (_build.EXTRA_FLAGS): each
// product and sum is rounded as the eager version rounds it.  The
// checkerboard's modulo is the floored one (-1 % 2 == 1), as torch's
// `remainder` and jnp's `%`.
//
// What bounds it on an H100: the 16 bytes of rgba a pixel writes (3.35
// TB/s), against some 400 float32 operations a pixel; PERF.md gives the
// count and the measured time.
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
#define GPD_MAX_SPHERES 8
#define GPD_MAX_BOXES 8
#define GPD_RENDER_MAX_DRONES 8
#define GPD_BIG 1e9f

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

// One camera: eye, forward, right, up (ops/render.py's basis).
struct GpdCamera {
    float o[3], f[3], r[3], u[3];
};

// The closest hit so far.
struct GpdHit {
    float t, nx, ny, nz, cr, cg, cb;
    int id;
};

GPD_RHD float gpd_rmax(float a, float b) { return a > b ? a : b; }
GPD_RHD float gpd_rmin(float a, float b) { return a < b ? a : b; }
GPD_RHD float gpd_clamp_lo(float x, float lo) { return x < lo ? lo : x; }
GPD_RHD float gpd_sign(float x) {
    return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

GPD_RHD void gpd_consider(GpdHit& h, float t, float nx, float ny, float nz,
                          float cr, float cg, float cb, int id) {
    if (t < h.t) {
        h.t = t;
        h.nx = nx; h.ny = ny; h.nz = nz;
        h.cr = cr; h.cg = cg; h.cb = cb;
        h.id = id;
    }
}

// The camera of a drone at `pos` with attitude `q` (xyzw): the first column
// of the normalised quaternion's rotation is the view direction.
GPD_RHD void gpd_camera(const GpdRenderParams& p, const float* pos,
                        const float* q, GpdCamera& cam) {
    cam.o[0] = pos[0] + 0.0f;
    cam.o[1] = pos[1] + 0.0f;
    cam.o[2] = pos[2] + p.l;
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

GPD_RHD void gpd_sphere(GpdHit& h, const float* o, const float* d, float cx,
                        float cy, float cz, float r, float cr, float cg,
                        float cb, int id) {
    const float ocx = o[0] - cx, ocy = o[1] - cy, ocz = o[2] - cz;
    const float b = ocx * d[0] + ocy * d[1] + ocz * d[2];
    const float c2 = ocx * ocx + ocy * ocy + ocz * ocz - r * r;
    const float disc = b * b - c2;
    const float sq = sqrtf(gpd_clamp_lo(disc, 0.0f));
    const float t0 = -b - sq;
    const float t1 = -b + sq;
    float t = t0 > 1e-4f ? t0 : t1;
    t = (disc > 0.0f && t > 1e-4f) ? t : GPD_BIG;
    const float hx = o[0] + t * d[0] - cx;
    const float hy = o[1] + t * d[1] - cy;
    const float hz = o[2] + t * d[2] - cz;
    const float inv_n =
        1.0f / gpd_clamp_lo(sqrtf(hx * hx + hy * hy + hz * hz), 1e-9f);
    gpd_consider(h, t, hx * inv_n, hy * inv_n, hz * inv_n, cr, cg, cb, id);
}

GPD_RHD void gpd_box(GpdHit& h, const float* o, const float* d,
                     const float* c, const float* half, const float* col,
                     int id) {
    float tmin_ax[3], tmax_ax[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float dk = d[k];
        const float den = fabsf(dk) > 1e-9f ? dk
                                            : (dk >= 0.0f ? 1e-9f : -1e-9f);
        const float inv = 1.0f / den;
        const float lo = (c[k] - half[k] - o[k]) * inv;
        const float hi = (c[k] + half[k] - o[k]) * inv;
        tmin_ax[k] = gpd_rmin(lo, hi);
        tmax_ax[k] = gpd_rmax(lo, hi);
    }
    const float tx = tmin_ax[0], ty = tmin_ax[1], tz = tmin_ax[2];
    const float tmin = gpd_rmax(gpd_rmax(tx, ty), tz);
    const float tmax = gpd_rmin(gpd_rmin(tmax_ax[0], tmax_ax[1]), tmax_ax[2]);
    const bool hit = tmax > gpd_clamp_lo(tmin, 1e-4f);
    const float t = hit ? (tmin > 1e-4f ? tmin : tmax) : GPD_BIG;
    // the normal: the axis of entry (first maximum); sign(0) is 0
    const bool is_x = (tx >= ty) && (tx >= tz);
    const bool is_y = !is_x && (ty >= tz);
    const float nx = is_x ? -gpd_sign(d[0]) : 0.0f;
    const float ny = is_y ? -gpd_sign(d[1]) : 0.0f;
    const float nz = (is_x || is_y) ? 0.0f : -gpd_sign(d[2]);
    gpd_consider(h, t, nx, ny, nz, col[0], col[1], col[2], id);
}

// One pixel (column i, row j) of one camera: rgba, depth buffer, seg id.
// `drones` holds the env's drones as (x, y, z, radius).
GPD_RHD void gpd_render_pixel(const GpdRenderParams& p, const GpdCamera& cam,
                              const float* drones, int i, int j, float* rgba,
                              float& depth, int& seg) {
    const float px =
        (2.0f * ((float)i + 0.5f) / (float)p.width - 1.0f) * p.tan_half;
    const float py =
        (1.0f - 2.0f * ((float)j + 0.5f) / (float)p.height) * p.tan_half;
    float d[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) d[k] = cam.f[k] + px * cam.r[k] + py * cam.u[k];
    const float inv_len = 1.0f / sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
    d[0] = d[0] * inv_len; d[1] = d[1] * inv_len; d[2] = d[2] * inv_len;
    const float* o = cam.o;

    GpdHit h = {GPD_BIG, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, -1};
    for (int s = 0; s < p.n_spheres; ++s) {
        gpd_sphere(h, o, d, p.sphere[s][0], p.sphere[s][1], p.sphere[s][2],
                   p.sphere[s][3], p.sphere_color[s][0], p.sphere_color[s][1],
                   p.sphere_color[s][2], p.sphere_id[s]);
    }
    for (int m = 0; m < p.group; ++m) {
        const float* dm = drones + 4 * m;
        gpd_sphere(h, o, d, dm[0], dm[1], dm[2], dm[3], p.drone_color[0],
                   p.drone_color[1], p.drone_color[2], 100 + m);
    }
    for (int b = 0; b < p.n_boxes; ++b) {
        gpd_box(h, o, d, p.box_center[b], p.box_half[b], p.box_color[b],
                p.box_id[b]);
    }
    // ground plane z = 0, a checkerboard of the floored modulo
    float tp = fabsf(d[2]) > 1e-6f ? -o[2] / d[2] : GPD_BIG;
    tp = tp > 1e-4f ? tp : GPD_BIG;
    const float hpx = o[0] + tp * d[0], hpy = o[1] + tp * d[1];
    const float s = floorf(hpx) + floorf(hpy);
    const float checker = s - 2.0f * floorf(s * 0.5f);
    const float pc = checker > 0.5f ? p.checker[0] : p.checker[1];
    gpd_consider(h, tp, 0.0f, 0.0f, 1.0f, pc, pc, pc, 0);

    const bool hit = h.t < p.far;
    seg = hit ? h.id : -1;
    const float lam = gpd_clamp_lo(
        h.nx * p.light[0] + h.ny * p.light[1] + h.nz * p.light[2], 0.0f);
    const float shade = p.ambient + p.diffuse * lam;
    const float base[3] = {h.cr, h.cg, h.cb};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float v = (hit ? shade * base[k] : p.sky[k]) * 255.0f;
        rgba[k] = gpd_rmin(gpd_clamp_lo(v, 0.0f), 255.0f);
    }
    rgba[3] = 255.0f;
    const float z = gpd_rmin(gpd_clamp_lo(h.t, p.l), p.far);
    depth = p.depth_scale * (1.0f - p.l / z);
}

#if defined(__CUDACC__)
__global__ void __launch_bounds__(GPD_RENDER_THREADS)
render_kernel(const float* __restrict__ pos, int pos_s0, int pos_s1,
              const float* __restrict__ quat, int quat_s0, int quat_s1,
              float* __restrict__ rgba, int ld, float* __restrict__ depth,
              int* __restrict__ seg, int C,
              const __grid_constant__ GpdRenderParams p) {
    __shared__ GpdCamera cam;
    __shared__ float drones[4 * GPD_RENDER_MAX_DRONES];
    const int npix = p.width * p.height;
    const int pix = blockIdx.x * blockDim.x + threadIdx.x;
    for (int c = blockIdx.y; c < C; c += gridDim.y) {
        __syncthreads();  // the previous camera's readers are done
        const int t = threadIdx.x;
        if (t == 0) {
            const float cp[3] = {pos[(size_t)c * pos_s0],
                                 pos[(size_t)c * pos_s0 + pos_s1],
                                 pos[(size_t)c * pos_s0 + 2 * pos_s1]};
            const float cq[4] = {quat[(size_t)c * quat_s0],
                                 quat[(size_t)c * quat_s0 + quat_s1],
                                 quat[(size_t)c * quat_s0 + 2 * quat_s1],
                                 quat[(size_t)c * quat_s0 + 3 * quat_s1]};
            gpd_camera(p, cp, cq, cam);
        }
        if (t < p.group) {
            const size_t row = (size_t)(c / p.group) * p.group + t;
            const float dx = pos[row * pos_s0], dy = pos[row * pos_s0 + pos_s1],
                        dz = pos[row * pos_s0 + 2 * pos_s1];
            const float ex = dx - pos[(size_t)c * pos_s0],
                        ey = dy - pos[(size_t)c * pos_s0 + pos_s1],
                        ez = dz - pos[(size_t)c * pos_s0 + 2 * pos_s1];
            const float dist = sqrtf(ex * ex + ey * ey + ez * ez);
            drones[4 * t] = dx;
            drones[4 * t + 1] = dy;
            drones[4 * t + 2] = dz;
            drones[4 * t + 3] = dist < p.drone_excl ? 0.0f : p.drone_r;
        }
        __syncthreads();
        if (pix < npix) {
            float4 out;
            float dep;
            int sg;
            gpd_render_pixel(p, cam, drones, pix % p.width, pix / p.width,
                             &out.x, dep, sg);
            reinterpret_cast<float4*>(rgba + (size_t)c * ld)[pix] = out;
            if (depth != nullptr) depth[(size_t)c * npix + pix] = dep;
            if (seg != nullptr) seg[(size_t)c * npix + pix] = sg;
        }
    }
}
#endif

extern "C" int gpd_params_size() { return (int)sizeof(GpdRenderParams); }

// Blocks (in all) and threads per block of the launch gpd_render makes for
// C cameras of `npix` pixels: ceil(npix / GPD_RENDER_THREADS) blocks of
// pixels for each of min(C, 65535) cameras at once.
extern "C" void gpd_render_geometry(int C, int npix, int* blocks,
                                    int* threads) {
    *threads = GPD_RENDER_THREADS;
    const int cams = C < 65535 ? C : 65535;
    *blocks = (npix + GPD_RENDER_THREADS - 1) / GPD_RENDER_THREADS * cams;
}

#if defined(__CUDACC__)
// Launches on `stream`, does not synchronise, allocates nothing.  pos (C, 3)
// and quat (C, 4) are read through their element strides (camera, then
// component); rgba is C rows of `ld` floats, 16-byte aligned, the first
// W*H*4 of each written.  `depth` and `seg` ((C, H, W), contiguous) may be
// NULL.  Returns cudaGetLastError().
extern "C" int gpd_render(const float* pos, int pos_s0, int pos_s1,
                          const float* quat, int quat_s0, int quat_s1,
                          float* rgba, int ld, float* depth, int* seg, int C,
                          const GpdRenderParams* p, void* stream) {
    if (C <= 0) return 0;
    const int npix = p->width * p->height;
    const dim3 grid((npix + GPD_RENDER_THREADS - 1) / GPD_RENDER_THREADS,
                    C < 65535 ? C : 65535);
    render_kernel<<<grid, GPD_RENDER_THREADS, 0, (cudaStream_t)stream>>>(
        pos, pos_s0, pos_s1, quat, quat_s0, quat_s1, rgba, ld, depth, seg, C,
        *p);
    return (int)cudaGetLastError();
}
#endif
