// Fused EASGD updates for Hopper (sm_90a): the f64 bucket updates of Sync
// EASGD and Sync SGD, and the packed momentum-EASGD update of the multi-pod
// step, in one elementwise pass each.
//
// Replaces the TPU kernels of src/repro/kernels/elastic_update.py:
//   repro_sync_easgd_update  <- fused_sync_easgd_update (_sync_easgd_kernel)
//       W' = W - eta*(G + rho*(W - C))
//       C' = C + (eta*rho*P)*(R/P - C)          (only where c_out != NULL)
//   repro_sync_sgd_update    <- fused_sync_sgd_update (_sync_sgd_kernel)
//       V' = mu*V - eta*(R/P)
//       C' = C + V'
// R is the exchanged sum of the P workers' rows (weights for EASGD,
// gradients for SGD), read before any update.
//   repro_elastic_update     <- fused_elastic_update (_update_kernel),
//                               below the f64 pair
//
// Bitwise contract. The results must equal numpy's
// (repro/core/easgd_flat.py: worker_step, sync_master_easgd,
// sync_master_sgd) bit for bit. Every operation is an explicit
// round-to-nearest intrinsic (__dsub_rn, __dmul_rn, __dadd_rn, __ddiv_rn)
// in the reference's order, so nvcc cannot contract a multiply and an add
// into an FMA whatever the flags; eta*rho*P is computed on the host as
// (eta*rho)*P, exactly as the reference does.
//
// Bound on the card. Each kernel is a pure streaming pass with a handful of
// f64 operations per element: it is bound by device-memory bytes, not by
// operations. Easgd moves 6*8*n bytes (reads W, G, C, R; writes W, C') on
// rank 0 and 4*8*n on the other ranks (no R read, no C' write); sgd moves
// 5*8*n (reads C, V, R; writes C, V). At AlexNet's n = 6,976,842 that is
// 334.9 MB and 279.1 MB: about 0.100 ms and 0.083 ms at the H100 SXM data
// sheet's 3.35 TB/s.
//
// Design against that bound: one grid-stride pass, each input read once and
// each output written once, nothing staged or re-read. The loop masks its
// own tail, so any bucket length works. The kernels allocate nothing and do
// not synchronise; they launch on the stream they are given. Vectorised
// 16-byte accesses and a tuned grid are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long kMaxBlocks = 132L * 16L;   // 16 blocks per H100 SM

// n > 0 (the Python wrapper launches nothing for an empty row)
unsigned grid_for(long n) {
    const long blocks = (n + kThreads - 1) / kThreads;
    return (unsigned)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

__global__ void sync_easgd_kernel(double* w, const double* g, const double* c,
                                  const double* r, double* c_out, long n,
                                  double eta, double rho, double alpha_p,
                                  double p) {
    const long stride = (long)gridDim.x * blockDim.x;
    for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
        const double wi = w[i];
        const double ci = c[i];
        // w - eta * (g + rho * (w - c))
        const double pull = __dmul_rn(rho, __dsub_rn(wi, ci));
        w[i] = __dsub_rn(wi, __dmul_rn(eta, __dadd_rn(g[i], pull)));
        if (c_out != nullptr) {
            // c + alpha_p * (r / p - c)
            const double mean = __ddiv_rn(r[i], p);
            c_out[i] = __dadd_rn(ci, __dmul_rn(alpha_p, __dsub_rn(mean, ci)));
        }
    }
}

__global__ void sync_sgd_kernel(double* c, double* v, const double* r, long n,
                                double eta, double mu, double p) {
    const long stride = (long)gridDim.x * blockDim.x;
    for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
        // v' = mu * v - eta * (r / p);  c' = c + v'
        const double mean = __ddiv_rn(r[i], p);
        const double vn = __dsub_rn(__dmul_rn(mu, v[i]), __dmul_rn(eta, mean));
        v[i] = vn;
        c[i] = __dadd_rn(c[i], vn);
    }
}

}  // namespace

// W is updated in place; C' goes to c_out, which may be NULL (ranks other
// than 0 update only their own weights). r is read only when c_out is set.
// Returns cudaGetLastError() after the launch.
extern "C" int repro_sync_easgd_update(double* w, const double* g,
                                       const double* c, const double* r,
                                       double* c_out, long n, double eta,
                                       double rho, double alpha_p, int p,
                                       void* stream) {
    sync_easgd_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        w, g, c, r, c_out, n, eta, rho, alpha_p, (double)p);
    return (int)cudaGetLastError();
}

// C and V are updated in place. Returns cudaGetLastError() after the launch.
extern "C" int repro_sync_sgd_update(double* c, double* v, const double* r,
                                     long n, double eta, double mu, int p,
                                     void* stream) {
    sync_sgd_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        c, v, r, n, eta, mu, (double)p);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fused_elastic_update: the packed momentum-EASGD step of the multi-pod
// trainer (src/repro/core/elastic.py:299-302, the Pallas _update_kernel)
//
//   V' = mu*V - eta*G
//   W' = W + V' - (eta*rho)*(W - C)
//   C' = C + ((eta*rho)*P)*(M - C)        (M = pod mean of the pre-update W)
//
// W, V and G are (P, n) rows (pods outer) and C, M are (n,); every buffer
// is stored as f32 or bf16 (its own dtype code: 0 f32, 1 bf16) and the
// math is f32, as the Pallas kernel computes it. W, V and C are updated in
// place. The four constants are f32(mu), f32(eta), f32(eta*rho) and
// f32((eta*rho)*P), each formed in double on the host as the reference's
// Python floats are; every operation is an explicit round-to-nearest
// intrinsic in the reference's order, so no multiply and add contract into
// an FMA and the kernel equals its plain torch version bit for bit.
//
// Bound on the card: a streaming pass of a few flops per element, bound by
// device-memory bytes. Per element index j it moves P*(3 reads + 2 writes)
// + 2 reads + 1 write: 52 bytes at P = 2 in f32, so 64.3 GB (19.2 ms at
// 3.35 TB/s) for full-width gemma3-4b at 6 layers.
//
// Design against that bound: one thread per element index j takes all P
// pods, so C[j] and M[j] are read once and C'[j] written once; each input
// is read once and each output written once, neighbouring threads on
// neighbouring addresses in every row. Any n: the grid-stride loop masks
// its own tail. Vectorised 16-byte accesses are left for later work.
// ---------------------------------------------------------------------------

namespace {

__device__ __forceinline__ float load_f32(const void* p, int bf16, long i) {
    return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_f32(void* p, int bf16, long i,
                                          float x) {
    if (bf16) {
        static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);
    } else {
        static_cast<float*>(p)[i] = x;
    }
}

__global__ void elastic_update_kernel(void* w, void* v, const void* g,
                                      void* c, const void* m, long n, int p,
                                      float mu, float eta, float eta_rho,
                                      float alpha_p, int dt_w, int dt_v,
                                      int dt_g, int dt_c, int dt_m) {
    const long stride = (long)gridDim.x * blockDim.x;
    for (long j = (long)blockIdx.x * blockDim.x + threadIdx.x; j < n;
         j += stride) {
        const float cj = load_f32(c, dt_c, j);
        const float mj = load_f32(m, dt_m, j);
        for (int i = 0; i < p; ++i) {
            const long k = (long)i * n + j;
            const float wk = load_f32(w, dt_w, k);
            // v' = mu * v - eta * g
            const float vn = __fsub_rn(__fmul_rn(mu, load_f32(v, dt_v, k)),
                                       __fmul_rn(eta, load_f32(g, dt_g, k)));
            // w' = (w + v') - eta_rho * (w - c)
            const float wn = __fsub_rn(__fadd_rn(wk, vn),
                                       __fmul_rn(eta_rho, __fsub_rn(wk, cj)));
            store_f32(v, dt_v, k, vn);
            store_f32(w, dt_w, k, wn);
        }
        // c' = c + alpha_p * (m - c)
        store_f32(c, dt_c, j,
                  __fadd_rn(cj, __fmul_rn(alpha_p, __fsub_rn(mj, cj))));
    }
}

}  // namespace

// W, V and C are updated in place. Returns cudaGetLastError() after the
// launch.
extern "C" int repro_elastic_update(void* w, void* v, const void* g, void* c,
                                    const void* m, long n, int p, float mu,
                                    float eta, float eta_rho, float alpha_p,
                                    int dt_w, int dt_v, int dt_g, int dt_c,
                                    int dt_m, void* stream) {
    elastic_update_kernel<<<grid_for(n), kThreads, 0,
                            (cudaStream_t)stream>>>(
        w, v, g, c, m, n, p, mu, eta, eta_rho, alpha_p, dt_w, dt_v, dt_g,
        dt_c, dt_m);
    return (int)cudaGetLastError();
}
