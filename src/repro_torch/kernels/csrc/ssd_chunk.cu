// Mamba-2 SSD intra-chunk block, forward and backward, for Hopper (sm_90a),
// f32 storage and f32 FMA on the CUDA cores.
//
// Replaces:
//   repro_ssd_fwd  <- src/repro/kernels/ssd_chunk.py ssd_intra_chunk
//                     (_ssd_intra_kernel): per (batch.head, chunk)
//                     Y_i = sum_{j<=i} (C_i.B_j) exp(cum_i - cum_j) X_j,
//                     cum the in-chunk cumsum of the log-decay a
//   repro_ssd_bwd  <- its gradient, which the reference leaves to XLA's
//                     autodiff of _ssd_chunked (src/repro/models/ssm.py:74):
//                     the TPU kernel is forward-only
//
// Layout: a, cum, da (BH, S); x, y, dx, dy (BH, S, P); b, c, db, dc
// (B, S, N), shared by the H heads of a batch row: head bh reads row
// bh / H, and nothing is broadcast per head. Scratch the caller allocates:
// g and dgs (B, nc, L, L); rpart and cpart (BH, nc, nt, L), nt = ceil(L/64).
//
// Bound on the card. At mamba2-780m's full width (H 48, P 64, N 128,
// L 256, S 4096) the forward does about nc (L^2 N + H L^2 P) flop over the
// causal half, 3.4e9 per sample and layer, and the backward about
// nc (3 L^2 N + 2 H L^2 P), 6.9e9: operations bound both (about 0.05 and
// 0.10 ms at 67 TFLOP/s in f32), the bytes (about 106 MB forward) less so.
// These kernels are the simple version: f32 FMA from shared-memory tiles,
// no tensor cores (TF32 would break the f32 contract), no copy pipeline.
// What the design keeps:
//   - G = C.B^T is formed once per (batch row, chunk), never per head, and
//     the backward sums dG over the H heads before its two products with
//     B and C (one product per chunk instead of H);
//   - an L x L chunk does not fit in shared memory at L = 256 (256 KiB in
//     f32), so every product runs over 64 x 64 tiles, and tiles above the
//     diagonal are skipped;
//   - exp(cum_i - cum_j) is formed as the exponent of the difference, and
//     only where i >= j: exp(cum_i) exp(-cum_j) overflows once a chunk's
//     decay passes -88, and the exponent above the diagonal would give
//     inf * 0 = NaN before any mask;
//   - every sum has one owner and a fixed order: db, dc and da are
//     deterministic without atomics.
//
// Kernels: ssd_cumsum (one thread per (bh, chunk), sequential, as the CPU
// cumsum sums); ssd_gram (G per tile pair); ssd_y (Y per row tile, head);
// ssd_dx (dX = M^T dY per column tile, head); ssd_dg (per tile pair, a
// loop over the heads: dM = dY X^T, dG_h = dM exp(.), dGs += dG_h, and the
// row and column sums of Q = dG_h G for dcum); ssd_dbc (dC = dGs B,
// dB = dGs^T C); ssd_da (dcum = row sums - column sums, then da is its
// reverse cumsum in the chunk). 256 threads; a 64 x 64 output tile is 4 x 4
// per thread. Shared tiles have a padded row stride (65) so that row and
// column walks do not conflict on banks. The launchers allocate nothing, do
// not synchronise, and return cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kT = 64;            // tile edge
constexpr int kLd = kT + 1;       // row stride of a shared tile
constexpr int kThreads = 256;

// dst[r][k] = src[r * ld + k] for r < rows, k < cols, else 0
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long ld, int rows, int cols) {
    for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
        const int r = e / kT, k = e % kT;
        dst[r * kLd + k] = (r < rows && k < cols) ? src[(long)r * ld + k]
                                                  : 0.f;
    }
}

// acc[i][n] += sum_k A(r0 + i, k) B(k, c0 + 16 n), k < 64, with
// A(r, k) = A[r * ars + k * aks] and B(k, q) = B[k * bks + q * bcs];
// this thread's rows r0 .. r0 + 4 and columns c0 + 16 n
__device__ __forceinline__ void mma(float (&acc)[4][4], const float* A,
                                    int ars, int aks, const float* B,
                                    int bks, int bcs) {
    const int r0 = (threadIdx.x / 16) * 4, c0 = threadIdx.x % 16;
#pragma unroll 4
    for (int k = 0; k < kT; ++k) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = A[(r0 + i) * ars + k * aks];
#pragma unroll
        for (int n = 0; n < 4; ++n) bv[n] = B[k * bks + (c0 + 16 * n) * bcs];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int n = 0; n < 4; ++n)
                acc[i][n] = fmaf(av[i], bv[n], acc[i][n]);
    }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[i][n] = 0.f;
}

// dst[(r0 + i) * ld + c0 + 16 n] = acc[i][n] where r < rows and q < cols
__device__ __forceinline__ void store_tile(float* dst, long ld,
                                           const float (&acc)[4][4],
                                           int rows, int cols) {
    const int r0 = (threadIdx.x / 16) * 4, c0 = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < 4; ++n)
            if (r0 + i < rows && c0 + 16 * n < cols)
                dst[(long)(r0 + i) * ld + c0 + 16 * n] = acc[i][n];
}

// M[r][s] = G_ij exp(cum_i - cum_j) for i = i0 + r >= j = j0 + s, both
// < L; 0 elsewhere (the exponent is never formed there). g points at
// G[i0][j0] (row stride L), cum at the chunk's first element.
__device__ __forceinline__ void build_m(float* Ms, const float* g,
                                        const float* cum, int i0, int j0,
                                        int L) {
    for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
        const int r = e / kT, s = e % kT, i = i0 + r, j = j0 + s;
        Ms[r * kLd + s] = (i < L && j <= i)
                              ? g[(long)r * L + s] * expf(cum[i] - cum[j])
                              : 0.f;
    }
}

__global__ void __launch_bounds__(kThreads)
ssd_cumsum(const float* __restrict__ a, float* __restrict__ cum, int rows,
           int L) {
    const long t = (long)blockIdx.x * kThreads + threadIdx.x;
    if (t >= rows) return;          // one (bh, chunk) each
    const float* src = a + t * L;
    float* dst = cum + t * L;
    float s = 0.f;
    for (int l = 0; l < L; ++l) {
        s += src[l];
        dst[l] = s;
    }
}

// G[b][c] tile (it, jt), jt <= it; grid (nt * nt, nc, B)
__global__ void __launch_bounds__(kThreads)
ssd_gram(const float* __restrict__ b, const float* __restrict__ c,
         float* __restrict__ g, int S, int L, int N, int nc, int nt) {
    __shared__ float Cs[kT * kLd], Bs[kT * kLd];
    const int it = blockIdx.x / nt, jt = blockIdx.x % nt;
    if (jt > it) return;
    const int ch = blockIdx.y, bb = blockIdx.z, i0 = it * kT, j0 = jt * kT;
    const long row0 = (long)bb * S + (long)ch * L;
    float acc[4][4];
    zero(acc);
    for (int n0 = 0; n0 < N; n0 += kT) {
        __syncthreads();
        load_tile(Cs, c + (row0 + i0) * N + n0, N, L - i0, N - n0);
        load_tile(Bs, b + (row0 + j0) * N + n0, N, L - j0, N - n0);
        __syncthreads();
        mma(acc, Cs, kLd, 1, Bs, 1, kLd);
    }
    float* gt = g + ((long)bb * nc + ch) * L * L;
    store_tile(gt + (long)i0 * L + j0, L, acc, L - i0, L - j0);
}

// Y rows of tile it, columns p0 .. p0 + 64 of head bh; grid (nt * np,
// nc, BH)
__global__ void __launch_bounds__(kThreads)
ssd_y(const float* __restrict__ x, const float* __restrict__ cum,
      const float* __restrict__ g, float* __restrict__ y, int H, int S,
      int L, int P, int nc, int np) {
    __shared__ float Ms[kT * kLd], Xs[kT * kLd];
    const int it = blockIdx.x / np, p0 = (blockIdx.x % np) * kT;
    const int ch = blockIdx.y, bh = blockIdx.z, bb = bh / H, i0 = it * kT;
    const long row0 = (long)bh * S + (long)ch * L;
    const float* gc = g + ((long)bb * nc + ch) * L * L;
    float acc[4][4];
    zero(acc);
    for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kT;
        __syncthreads();
        build_m(Ms, gc + (long)i0 * L + j0, cum + row0, i0, j0, L);
        load_tile(Xs, x + (row0 + j0) * P + p0, P, L - j0, P - p0);
        __syncthreads();
        mma(acc, Ms, kLd, 1, Xs, kLd, 1);
    }
    store_tile(y + (row0 + i0) * P + p0, P, acc, L - i0, P - p0);
}

// dX rows of tile jt: dX_j = sum_{i >= j} M_ij dY_i; grid (nt * np, nc, BH)
__global__ void __launch_bounds__(kThreads)
ssd_dx(const float* __restrict__ dy, const float* __restrict__ cum,
       const float* __restrict__ g, float* __restrict__ dx, int H, int S,
       int L, int P, int nc, int nt, int np) {
    __shared__ float Ms[kT * kLd], Ys[kT * kLd];
    const int jt = blockIdx.x / np, p0 = (blockIdx.x % np) * kT;
    const int ch = blockIdx.y, bh = blockIdx.z, bb = bh / H, j0 = jt * kT;
    const long row0 = (long)bh * S + (long)ch * L;
    const float* gc = g + ((long)bb * nc + ch) * L * L;
    float acc[4][4];
    zero(acc);
    for (int it = jt; it < nt; ++it) {
        const int i0 = it * kT;
        __syncthreads();
        build_m(Ms, gc + (long)i0 * L + j0, cum + row0, i0, j0, L);
        load_tile(Ys, dy + (row0 + i0) * P + p0, P, L - i0, P - p0);
        __syncthreads();
        mma(acc, Ms, 1, kLd, Ys, kLd, 1);       // M^T . dY
    }
    store_tile(dx + (row0 + j0) * P + p0, P, acc, L - j0, P - p0);
}

// tile pair (it, jt), jt <= it, of batch row bb: over the H heads in order,
// dM = dY_i X_j^T, dG_h = dM exp(cum_i - cum_j) (i >= j), dGs += dG_h, and
// Q = dG_h G's row sums -> rpart[bh][c][jt][i], column sums ->
// cpart[bh][c][it][j]. Writes dGs's tile. Grid (nt * nt, nc, B).
__global__ void __launch_bounds__(kThreads)
ssd_dg(const float* __restrict__ x, const float* __restrict__ dy,
       const float* __restrict__ cum, const float* __restrict__ g,
       float* __restrict__ dgs, float* __restrict__ rpart,
       float* __restrict__ cpart, int H, int S, int L, int P, int nc,
       int nt) {
    __shared__ float Ys[kT * kLd], Xs[kT * kLd];
    float* Qs = Ys;                 // reused once dM is formed
    const int it = blockIdx.x / nt, jt = blockIdx.x % nt;
    if (jt > it) return;
    const int ch = blockIdx.y, bb = blockIdx.z, i0 = it * kT, j0 = jt * kT;
    const int r0 = (threadIdx.x / 16) * 4, c0 = threadIdx.x % 16;
    const float* gt = g + ((long)bb * nc + ch) * L * L + (long)i0 * L + j0;
    bool valid[4][4];
    float gv[4][4], ds[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
            const int r = r0 + i, s = c0 + 16 * n;
            valid[i][n] = i0 + r < L && j0 + s <= i0 + r;
            gv[i][n] = valid[i][n] ? gt[(long)r * L + s] : 0.f;
            ds[i][n] = 0.f;
        }
    for (int h = 0; h < H; ++h) {
        const int bh = bb * H + h;
        const long row0 = (long)bh * S + (long)ch * L;
        const float* cm = cum + row0;
        float dm[4][4];
        zero(dm);
        for (int p0 = 0; p0 < P; p0 += kT) {
            __syncthreads();
            load_tile(Ys, dy + (row0 + i0) * P + p0, P, L - i0, P - p0);
            load_tile(Xs, x + (row0 + j0) * P + p0, P, L - j0, P - p0);
            __syncthreads();
            mma(dm, Ys, kLd, 1, Xs, 1, kLd);    // dY . X^T
        }
        __syncthreads();            // every thread is done with Ys
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int n = 0; n < 4; ++n) {
                const int r = r0 + i, s = c0 + 16 * n;
                float q = 0.f;
                if (valid[i][n]) {
                    const float dgh =
                        dm[i][n] * expf(cm[i0 + r] - cm[j0 + s]);
                    ds[i][n] += dgh;
                    q = dgh * gv[i][n];
                }
                Qs[r * kLd + s] = q;
            }
        __syncthreads();
        const long part = ((long)bh * nc + ch) * nt;
        const int t = threadIdx.x;
        if (t < kT) {
            if (i0 + t < L) {
                float sum = 0.f;
                for (int s = 0; s < kT; ++s) sum += Qs[t * kLd + s];
                rpart[(part + jt) * L + i0 + t] = sum;
            }
        } else if (t < 2 * kT) {
            const int s = t - kT;
            if (j0 + s < L) {
                float sum = 0.f;
                for (int r = 0; r < kT; ++r) sum += Qs[r * kLd + s];
                cpart[(part + it) * L + j0 + s] = sum;
            }
        }
    }
    float* dt = dgs + ((long)bb * nc + ch) * L * L + (long)i0 * L + j0;
    store_tile(dt, L, ds, L - i0, L - j0);
}

// which 0: dC rows of tile t = sum_{j <= i} dGs_ij B_j; which 1: dB rows of
// tile t = sum_{i >= j} dGs_ij C_i. Grid (nt * nn, nc, 2 B).
__global__ void __launch_bounds__(kThreads)
ssd_dbc(const float* __restrict__ b, const float* __restrict__ c,
        const float* __restrict__ dgs, float* __restrict__ db,
        float* __restrict__ dc, int S, int L, int N, int nc, int nt,
        int nn) {
    __shared__ float Ds[kT * kLd], Vs[kT * kLd];
    const int t = blockIdx.x / nn, n0 = (blockIdx.x % nn) * kT;
    const int ch = blockIdx.y, bb = blockIdx.z / 2, which = blockIdx.z % 2;
    const long row0 = (long)bb * S + (long)ch * L;
    const float* dc_ = dgs + ((long)bb * nc + ch) * L * L;
    float acc[4][4];
    zero(acc);
    if (which == 0) {
        const int i0 = t * kT;
        for (int jt = 0; jt <= t; ++jt) {
            const int j0 = jt * kT;
            __syncthreads();
            load_tile(Ds, dc_ + (long)i0 * L + j0, L, L - i0, L - j0);
            load_tile(Vs, b + (row0 + j0) * N + n0, N, L - j0, N - n0);
            __syncthreads();
            mma(acc, Ds, kLd, 1, Vs, kLd, 1);
        }
        store_tile(dc + (row0 + i0) * N + n0, N, acc, L - i0, N - n0);
    } else {
        const int j0 = t * kT;
        for (int it = t; it < nt; ++it) {
            const int i0 = it * kT;
            __syncthreads();
            load_tile(Ds, dc_ + (long)i0 * L + j0, L, L - i0, L - j0);
            load_tile(Vs, c + (row0 + i0) * N + n0, N, L - i0, N - n0);
            __syncthreads();
            mma(acc, Ds, 1, kLd, Vs, kLd, 1);   // dGs^T . C
        }
        store_tile(db + (row0 + j0) * N + n0, N, acc, L - j0, N - n0);
    }
}

// da of one (chunk, bh): dcum_k = sum_{jt <= k/64} rpart - sum_{it >=
// k/64} cpart, then da_t = sum_{k >= t} dcum_k. Grid (nc, BH), dynamic
// shared memory L floats.
__global__ void __launch_bounds__(kThreads)
ssd_da(const float* __restrict__ rpart, const float* __restrict__ cpart,
       float* __restrict__ da, int S, int L, int nc, int nt) {
    extern __shared__ float dcum[];
    const int ch = blockIdx.x, bh = blockIdx.y;
    const long part = ((long)bh * nc + ch) * nt;
    for (int k = threadIdx.x; k < L; k += kThreads) {
        const int kt = k / kT;
        float rs = 0.f, cs = 0.f;
        for (int jt = 0; jt <= kt; ++jt) rs += rpart[(part + jt) * L + k];
        for (int it = kt; it < nt; ++it) cs += cpart[(part + it) * L + k];
        dcum[k] = rs - cs;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        float* out = da + (long)bh * S + (long)ch * L;
        float s = 0.f;
        for (int k = L - 1; k >= 0; --k) {
            s += dcum[k];
            out[k] = s;
        }
    }
}

int cumsum(const float* a, float* cum, int BH, int S, int L,
           cudaStream_t st) {
    const int rows = BH * (S / L);
    ssd_cumsum<<<(rows + kThreads - 1) / kThreads, kThreads, 0, st>>>(
        a, cum, rows, L);
    return (int)cudaGetLastError();
}

int gram(const float* b, const float* c, float* g, int B, int S, int L,
         int N, cudaStream_t st) {
    const int nc = S / L, nt = (L + kT - 1) / kT;
    ssd_gram<<<dim3(nt * nt, nc, B), kThreads, 0, st>>>(b, c, g, S, L, N,
                                                         nc, nt);
    return (int)cudaGetLastError();
}

}  // namespace

// a (BH, S), x (BH, S, P), b, c (B, S, N), y (BH, S, P), all f32 and
// contiguous, BH = B H, S a multiple of L. Scratch: cum (BH, S) and
// g (B, S / L, L, L).
extern "C" int repro_ssd_fwd(const float* a, const float* x, const float* b,
                             const float* c, float* y, float* cum, float* g,
                             int B, int H, int S, int L, int P, int N,
                             void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (L <= 0 || S % L || P <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
    const int nc = S / L, nt = (L + kT - 1) / kT, np = (P + kT - 1) / kT;
    if (int rc = cumsum(a, cum, B * H, S, L, st)) return rc;
    if (int rc = gram(b, c, g, B, S, L, N, st)) return rc;
    ssd_y<<<dim3(nt * np, nc, B * H), kThreads, 0, st>>>(x, cum, g, y, H, S,
                                                         L, P, nc, np);
    return (int)cudaGetLastError();
}

// dy (BH, S, P) in; dx (BH, S, P), db, dc (B, S, N), da (BH, S) out.
// Scratch: cum (BH, S); g, dgs (B, S / L, L, L); rpart, cpart
// (BH, S / L, nt, L), nt = ceil(L / 64).
extern "C" int repro_ssd_bwd(const float* a, const float* x, const float* b,
                             const float* c, const float* dy, float* dx,
                             float* db, float* dc, float* da, float* cum,
                             float* g, float* dgs, float* rpart,
                             float* cpart, int B, int H, int S, int L, int P,
                             int N, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (L <= 0 || S % L || P <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
    const int nc = S / L, nt = (L + kT - 1) / kT, np = (P + kT - 1) / kT;
    const int nn = (N + kT - 1) / kT;
    if (int rc = cumsum(a, cum, B * H, S, L, st)) return rc;
    if (int rc = gram(b, c, g, B, S, L, N, st)) return rc;
    ssd_dx<<<dim3(nt * np, nc, B * H), kThreads, 0, st>>>(
        dy, cum, g, dx, H, S, L, P, nc, nt, np);
    if (int rc = (int)cudaGetLastError()) return rc;
    ssd_dg<<<dim3(nt * nt, nc, B), kThreads, 0, st>>>(
        x, dy, cum, g, dgs, rpart, cpart, H, S, L, P, nc, nt);
    if (int rc = (int)cudaGetLastError()) return rc;
    ssd_dbc<<<dim3(nt * nn, nc, 2 * B), kThreads, 0, st>>>(
        b, c, dgs, db, dc, S, L, N, nc, nt, nn);
    if (int rc = (int)cudaGetLastError()) return rc;
    const size_t smem = sizeof(float) * (size_t)L;
    if (smem > 48 * 1024) {
        if (int rc = (int)cudaFuncSetAttribute(
                ssd_da, cudaFuncAttributeMaxDynamicSharedMemorySize,
                (int)smem))
            return rc;
    }
    ssd_da<<<dim3(nc, B * H), kThreads, smem, st>>>(rpart, cpart, da, S, L,
                                                    nc, nt);
    return (int)cudaGetLastError();
}
