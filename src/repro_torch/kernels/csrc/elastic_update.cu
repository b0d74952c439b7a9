// Fused f64 sync-family updates for Hopper (sm_90a): the bucket updates of
// Sync EASGD and Sync SGD in one elementwise pass each.
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
