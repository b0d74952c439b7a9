// Flash attention forward and backward for Hopper (sm_90a), f32 or bf16
// storage with f32 scores, statistics and accumulators.
//
// Replaces:
//   repro_flash_fwd  <- src/repro/kernels/flash_attention.py
//                       flash_attention_bhsd (_attn_kernel), and the
//                       training forward _flash_fwd_impl
//                       (src/repro/models/attention.py:175)
//   repro_flash_bwd  <- _flash_bwd_impl (src/repro/models/attention.py:222),
//                       pure JAX in the reference: the TPU kernel is
//                       forward-only
//
// Layout: q, out, dout (B, S, H, D); k, v (B, S, KVH, D); lse, delta
// (B, S, H) f32. Head h reads KV head h / (H / KVH): K and V are never
// expanded per query head (the reference's GQA wrapper repeats them).
// Masks: key < S, causal (query >= key), window (query - key < window;
// 0 = none). Masked scores are -1e30, not -inf, as in the reference.
//
// The arithmetic follows the reference's training path: s = (q.k) * scale
// in f32; online softmax per kv tile; p rounded to v's dtype before p.V;
// l sums the unrounded p. Backward: p = exp(s - lse), dv += round(p)^T.dO,
// dp = dO.V^T, ds = p (dp - delta) scale, dq += round(ds).K,
// dk += round(ds)^T.Q, delta = sum(dO * O).
//
// Bound on the card. The training shapes (S 4096, D 256, H 8, KVH 4) do
// about 2 S^2 D H flops per product over the unmasked part (half of it
// causal, a quarter of it or less under the 1024 window): the work is bound
// by operations, not bytes. These kernels are the simple version: f32
// FMA on CUDA cores from shared-memory tiles (no tensor cores, no TMA), so
// they run far from the bf16 tensor-core bound. What the design does keep:
// the S x S scores never leave shared memory; kv tiles that the causal and
// window masks hide entirely are skipped; dk and dv are summed over the G
// query heads of a KV head inside one block, in a fixed order, so the
// backward is deterministic without atomics.
//
// Blocks: forward (q tile of 64 rows, head, batch), kv tiles of 64; the
// backward's dk/dv pass (kv tile of 32, kv head, batch) loops over the G
// heads and the q tiles; its dq pass (q tile of 32, head, batch) loops over
// kv tiles. Tiles are staged in shared memory as f32 with a padded row
// stride (D + 1) so that column walks do not conflict on banks. Ragged
// tails are zero-filled and masked. The launchers allocate nothing, do not
// synchronise, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
    return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);   // round to nearest even, as astype
}
template <typename T> __device__ __forceinline__ float round_to(float x) {
    return to_f(from_f<T>(x));
}

__device__ __forceinline__ bool allowed(int qpos, int kpos, int S, int causal,
                                        int window) {
    if (kpos >= S) return false;
    if (causal && qpos < kpos) return false;
    if (window && qpos - kpos >= window) return false;
    return true;
}

// kv tiles [lo, hi) holding a key that some query in [q0, q1) may see
__device__ __forceinline__ void kv_range(int q0, int q1, int S, int bk,
                                         int causal, int window, int* lo,
                                         int* hi) {
    int last = S - 1;
    if (causal) last = min(last, q1 - 1);
    int first = 0;
    if (window) first = max(0, q0 - window + 1);
    *lo = first / bk;
    *hi = first > last ? *lo : last / bk + 1;
}

// q tiles [lo, hi) holding a query that may see some key in [k0, k1)
__device__ __forceinline__ void q_range(int k0, int k1, int S, int bq,
                                        int causal, int window, int* lo,
                                        int* hi) {
    const int first = causal ? k0 : 0;
    int last = S - 1;
    if (window) last = min(last, k1 - 1 + window - 1);
    *lo = first / bq;
    *hi = first > last ? *lo : last / bq + 1;
}

// rows [r0, r0 + n) of one head of a (B, S, heads, D) tensor -> f32 tile
// with row stride ld; rows at or past S are zero
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* base,
                                          long row_stride, int r0, int n,
                                          int S) {
    for (int i = threadIdx.x; i < n * D; i += kThreads) {
        const int r = i / D, c = i % D;
        dst[r * ld + c] =
            r0 + r < S ? to_f(base[(long)(r0 + r) * row_stride + c]) : 0.f;
    }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ out,
                float* __restrict__ lse, int S, int H, int KVH, int causal,
                int window, float scale) {
    constexpr int BQ = 64, BK = 64, QS = D + 1, SS = BK + 1;
    constexpr int RP = BQ * D / kThreads;     // output rows per thread
    extern __shared__ float smem[];
    float* q_s = smem;                        // [BQ][QS]
    float* k_s = q_s + BQ * QS;               // [BK][QS]
    float* v_s = k_s + BK * QS;               // [BK][D]
    float* s_s = v_s + BK * D;                // [BQ][SS]
    float* m_s = s_s + BQ * SS;               // [BQ] running max
    float* l_s = m_s + BQ;                    // [BQ] running sum
    float* c_s = l_s + BQ;                    // [BQ] this tile's correction

    const int tid = threadIdx.x;
    const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
    const int kvh = h / (H / KVH);
    const long qrs = (long)H * D, kvrs = (long)KVH * D;
    const T* qb = q + (long)b * S * qrs + (long)h * D;
    const T* kb = k + (long)b * S * kvrs + (long)kvh * D;
    const T* vb = v + (long)b * S * kvrs + (long)kvh * D;

    load_rows<T, D>(q_s, QS, qb, qrs, q0, BQ, S);
    if (tid < BQ) {
        m_s[tid] = kNegInf;
        l_s[tid] = 0.f;
    }
    // output accumulator: column oc, rows orow .. orow + RP
    const int oc = tid % D, orow = (tid / D) * RP;
    float o[RP];
#pragma unroll
    for (int i = 0; i < RP; ++i) o[i] = 0.f;
    // scores: rows sr .. sr + 4, columns sc + 16 n
    const int sr = (tid / 16) * 4, sc = tid % 16;

    int lo, hi;
    kv_range(q0, min(q0 + BQ, S), S, BK, causal, window, &lo, &hi);
    for (int jt = lo; jt < hi; ++jt) {
        const int k0 = jt * BK;
        __syncthreads();
        load_rows<T, D>(k_s, QS, kb, kvrs, k0, BK, S);
        load_rows<T, D>(v_s, D, vb, kvrs, k0, BK, S);
        __syncthreads();
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int n = 0; n < 4; ++n) acc[i][n] = 0.f;
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
            float a[4], kk[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = q_s[(sr + i) * QS + d];
#pragma unroll
            for (int n = 0; n < 4; ++n) kk[n] = k_s[(sc + 16 * n) * QS + d];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int n = 0; n < 4; ++n)
                    acc[i][n] = fmaf(a[i], kk[n], acc[i][n]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int n = 0; n < 4; ++n) {
                const int r = sr + i, j = sc + 16 * n;
                s_s[r * SS + j] = allowed(q0 + r, k0 + j, S, causal, window)
                                      ? acc[i][n] * scale
                                      : kNegInf;
            }
        __syncthreads();
        {   // online softmax, four lanes per row
            const int r = tid / 4, part = tid % 4;
            float* row = s_s + r * SS + part * 16;
            float mx = kNegInf;
#pragma unroll
            for (int j = 0; j < 16; ++j) mx = fmaxf(mx, row[j]);
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_old = m_s[r];
            const float m_new = fmaxf(m_old, mx);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < 16; ++j) {
                const float p = expf(row[j] - m_new);
                sum += p;
                row[j] = round_to<T>(p);
            }
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            if (part == 0) {
                const float corr = expf(m_old - m_new);
                l_s[r] = l_s[r] * corr + sum;
                m_s[r] = m_new;
                c_s[r] = corr;
            }
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < RP; ++i) o[i] *= c_s[orow + i];
        for (int j = 0; j < BK; ++j) {
            const float vv = v_s[j * D + oc];
#pragma unroll
            for (int i = 0; i < RP; ++i)
                o[i] = fmaf(s_s[(orow + i) * SS + j], vv, o[i]);
        }
    }
    __syncthreads();
    T* ob = out + (long)b * S * qrs + (long)h * D;
#pragma unroll
    for (int i = 0; i < RP; ++i) {
        const int r = orow + i;
        if (q0 + r < S)
            ob[(long)(q0 + r) * qrs + oc] =
                from_f<T>(o[i] / fmaxf(l_s[r], 1e-30f));
    }
    if (tid < BQ && q0 + tid < S)
        lse[((long)b * S + q0 + tid) * H + h] =
            m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// delta = sum over D of dout * out, one warp per (b, s, h) row
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                  float* __restrict__ delta, long rows, int D) {
    const long row = ((long)blockIdx.x * kThreads + threadIdx.x) / 32;
    const int lane = threadIdx.x % 32;
    if (row >= rows) return;
    float s = 0.f;
    for (int c = lane; c < D; c += 32)
        s += to_f(dout[row * D + c]) * to_f(out[row * D + c]);
    for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) delta[row] = s;
}

// scores and dP of one (32 x 32) tile; this thread's row si, columns
// sj + 8 n. Writes round(p) to p_s (when given) and round(ds) to ds_s.
template <typename T, int D>
__device__ __forceinline__ void bwd_tile(const float* q_s, const float* o_s,
                                         const float* k_s, const float* v_s,
                                         const float* lse_s,
                                         const float* dl_s, float* p_s,
                                         float* ds_s, int q0, int k0, int S,
                                         int causal, int window,
                                         float scale) {
    constexpr int QS = D + 1, SS = 32 + 1;
    const int si = threadIdx.x / 8, sj = threadIdx.x % 8;
    float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
        const float a = q_s[si * QS + d], g = o_s[si * QS + d];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
            s[n] = fmaf(a, k_s[(sj + 8 * n) * QS + d], s[n]);
            dp[n] = fmaf(g, v_s[(sj + 8 * n) * QS + d], dp[n]);
        }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
        const int j = sj + 8 * n;
        float p = 0.f, ds = 0.f;
        if (q0 + si < S && allowed(q0 + si, k0 + j, S, causal, window)) {
            p = expf(s[n] * scale - lse_s[si]);
            ds = p * (dp[n] - dl_s[si]) * scale;
        }
        if (p_s != nullptr) p_s[si * SS + j] = round_to<T>(p);
        ds_s[si * SS + j] = round_to<T>(ds);
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int H, int KVH, int causal,
                     int window, float scale) {
    constexpr int BQ = 32, BK = 32, QS = D + 1, SS = BK + 1;
    constexpr int RP = BK * D / kThreads;     // dk / dv rows per thread
    extern __shared__ float smem[];
    float* k_s = smem;                        // [BK][QS]
    float* v_s = k_s + BK * QS;               // [BK][QS]
    float* q_s = v_s + BK * QS;               // [BQ][QS]
    float* o_s = q_s + BQ * QS;               // [BQ][QS] dout
    float* p_s = o_s + BQ * QS;               // [BQ][SS]
    float* ds_s = p_s + BQ * SS;              // [BQ][SS]
    float* lse_s = ds_s + BQ * SS;            // [BQ]
    float* dl_s = lse_s + BQ;                 // [BQ]

    const int tid = threadIdx.x;
    const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
    const int G = H / KVH;
    const long qrs = (long)H * D, kvrs = (long)KVH * D;
    const T* kb = k + (long)b * S * kvrs + (long)kvh * D;
    const T* vb = v + (long)b * S * kvrs + (long)kvh * D;
    load_rows<T, D>(k_s, QS, kb, kvrs, k0, BK, S);
    load_rows<T, D>(v_s, QS, vb, kvrs, k0, BK, S);

    const int ac = tid % D, arow = (tid / D) * RP;
    float dka[RP], dva[RP];
#pragma unroll
    for (int i = 0; i < RP; ++i) dka[i] = dva[i] = 0.f;

    int lo, hi;
    q_range(k0, min(k0 + BK, S), S, BQ, causal, window, &lo, &hi);
    for (int g = 0; g < G; ++g) {
        const int h = kvh * G + g;
        const T* qb = q + (long)b * S * qrs + (long)h * D;
        const T* ob = dout + (long)b * S * qrs + (long)h * D;
        for (int it = lo; it < hi; ++it) {
            const int q0 = it * BQ;
            __syncthreads();
            load_rows<T, D>(q_s, QS, qb, qrs, q0, BQ, S);
            load_rows<T, D>(o_s, QS, ob, qrs, q0, BQ, S);
            if (tid < BQ) {
                const bool ok = q0 + tid < S;
                const long at = ((long)b * S + q0 + tid) * H + h;
                lse_s[tid] = ok ? lse[at] : 0.f;
                dl_s[tid] = ok ? delta[at] : 0.f;
            }
            __syncthreads();
            bwd_tile<T, D>(q_s, o_s, k_s, v_s, lse_s, dl_s, p_s, ds_s, q0,
                           k0, S, causal, window, scale);
            __syncthreads();
            for (int i = 0; i < BQ; ++i) {
                const float gv = o_s[i * QS + ac], qv = q_s[i * QS + ac];
#pragma unroll
                for (int r = 0; r < RP; ++r) {
                    dva[r] = fmaf(p_s[i * SS + arow + r], gv, dva[r]);
                    dka[r] = fmaf(ds_s[i * SS + arow + r], qv, dka[r]);
                }
            }
        }
    }
    T* dkb = dk + (long)b * S * kvrs + (long)kvh * D;
    T* dvb = dv + (long)b * S * kvrs + (long)kvh * D;
#pragma unroll
    for (int r = 0; r < RP; ++r) {
        const int s = k0 + arow + r;
        if (s < S) {
            dkb[(long)s * kvrs + ac] = from_f<T>(dka[r]);
            dvb[(long)s * kvrs + ac] = from_f<T>(dva[r]);
        }
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq, int S,
                   int H, int KVH, int causal, int window, float scale) {
    constexpr int BQ = 32, BK = 32, QS = D + 1, SS = BK + 1;
    constexpr int RP = BQ * D / kThreads;     // dq rows per thread
    extern __shared__ float smem[];
    float* q_s = smem;                        // [BQ][QS]
    float* o_s = q_s + BQ * QS;               // [BQ][QS] dout
    float* k_s = o_s + BQ * QS;               // [BK][QS]
    float* v_s = k_s + BK * QS;               // [BK][QS]
    float* ds_s = v_s + BK * QS;              // [BQ][SS]
    float* lse_s = ds_s + BQ * SS;            // [BQ]
    float* dl_s = lse_s + BQ;                 // [BQ]

    const int tid = threadIdx.x;
    const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
    const int kvh = h / (H / KVH);
    const long qrs = (long)H * D, kvrs = (long)KVH * D;
    const T* kb = k + (long)b * S * kvrs + (long)kvh * D;
    const T* vb = v + (long)b * S * kvrs + (long)kvh * D;
    load_rows<T, D>(q_s, QS, q + (long)b * S * qrs + (long)h * D, qrs, q0,
                    BQ, S);
    load_rows<T, D>(o_s, QS, dout + (long)b * S * qrs + (long)h * D, qrs,
                    q0, BQ, S);
    if (tid < BQ) {
        const bool ok = q0 + tid < S;
        const long at = ((long)b * S + q0 + tid) * H + h;
        lse_s[tid] = ok ? lse[at] : 0.f;
        dl_s[tid] = ok ? delta[at] : 0.f;
    }
    const int ac = tid % D, arow = (tid / D) * RP;
    float dqa[RP];
#pragma unroll
    for (int i = 0; i < RP; ++i) dqa[i] = 0.f;

    int lo, hi;
    kv_range(q0, min(q0 + BQ, S), S, BK, causal, window, &lo, &hi);
    for (int jt = lo; jt < hi; ++jt) {
        const int k0 = jt * BK;
        __syncthreads();
        load_rows<T, D>(k_s, QS, kb, kvrs, k0, BK, S);
        load_rows<T, D>(v_s, QS, vb, kvrs, k0, BK, S);
        __syncthreads();
        bwd_tile<T, D>(q_s, o_s, k_s, v_s, lse_s, dl_s, nullptr, ds_s, q0,
                       k0, S, causal, window, scale);
        __syncthreads();
        for (int j = 0; j < BK; ++j) {
            const float kv = k_s[j * QS + ac];
#pragma unroll
            for (int r = 0; r < RP; ++r)
                dqa[r] = fmaf(ds_s[(arow + r) * SS + j], kv, dqa[r]);
        }
    }
    T* dqb = dq + (long)b * S * qrs + (long)h * D;
#pragma unroll
    for (int r = 0; r < RP; ++r) {
        const int s = q0 + arow + r;
        if (s < S) dqb[(long)s * qrs + ac] = from_f<T>(dqa[r]);
    }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename K>
int set_smem(K kernel, size_t bytes) {
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, void* out, float* lse,
        int B, int S, int H, int KVH, int causal, int window, float scale,
        cudaStream_t st) {
    constexpr int BQ = 64, BK = 64;
    const size_t bytes =
        sizeof(float) * ((BQ + BK) * (D + 1) + BK * D + BQ * (BK + 1) + 3 * BQ);
    auto kern = attn_fwd_kernel<T, D>;
    if (int rc = set_smem(kern, bytes)) return rc;
    const dim3 grid((S + BQ - 1) / BQ, H, B);
    kern<<<grid, kThreads, bytes, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, S, H, KVH,
        causal, window, scale);
    return (int)cudaGetLastError();
}

template <typename T, int D>
int bwd(const void* q, const void* k, const void* v, const void* out,
        const void* dout, const float* lse, float* delta, void* dq, void* dk,
        void* dv, int B, int S, int H, int KVH, int causal, int window,
        float scale, cudaStream_t st) {
    constexpr int BQ = 32, BK = 32;
    const long rows = (long)B * S * H;
    attn_delta_kernel<T><<<(unsigned)((rows * 32 + kThreads - 1) / kThreads),
                           kThreads, 0, st>>>((const T*)out, (const T*)dout,
                                              delta, rows, D);
    if (int rc = (int)cudaGetLastError()) return rc;

    const size_t b_kv = sizeof(float) *
                        (4 * 32 * (D + 1) + 2 * BQ * (BK + 1) + 2 * BQ);
    auto kkv = attn_bwd_dkdv_kernel<T, D>;
    if (int rc = set_smem(kkv, b_kv)) return rc;
    kkv<<<dim3((S + BK - 1) / BK, KVH, B), kThreads, b_kv, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
        (T*)dk, (T*)dv, S, H, KVH, causal, window, scale);
    if (int rc = (int)cudaGetLastError()) return rc;

    const size_t b_q = sizeof(float) *
                       (4 * 32 * (D + 1) + BQ * (BK + 1) + 2 * BQ);
    auto kq = attn_bwd_dq_kernel<T, D>;
    if (int rc = set_smem(kq, b_q)) return rc;
    kq<<<dim3((S + BQ - 1) / BQ, H, B), kThreads, b_q, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
        (T*)dq, S, H, KVH, causal, window, scale);
    return (int)cudaGetLastError();
}

#define REPRO_BY_HEAD_DIM(FN, T, ...)                        \
    switch (D) {                                             \
        case 16: return FN<T, 16>(__VA_ARGS__);              \
        case 32: return FN<T, 32>(__VA_ARGS__);              \
        case 64: return FN<T, 64>(__VA_ARGS__);              \
        case 128: return FN<T, 128>(__VA_ARGS__);            \
        case 256: return FN<T, 256>(__VA_ARGS__);            \
        default: return (int)cudaErrorInvalidValue;          \
    }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. D in {16, 32, 64, 128, 256}.
extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v,
                               void* out, float* lse, int B, int S, int H,
                               int KVH, int D, int causal, int window,
                               float scale, int dtype, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 0) {
        REPRO_BY_HEAD_DIM(fwd, float, q, k, v, out, lse, B, S, H, KVH,
                          causal, window, scale, st)
    }
    REPRO_BY_HEAD_DIM(fwd, __nv_bfloat16, q, k, v, out, lse, B, S, H, KVH,
                      causal, window, scale, st)
}

// delta is a (B, S, H) f32 scratch buffer the caller allocates.
extern "C" int repro_flash_bwd(const void* q, const void* k, const void* v,
                               const void* out, const void* dout,
                               const float* lse, float* delta, void* dq,
                               void* dk, void* dv, int B, int S, int H,
                               int KVH, int D, int causal, int window,
                               float scale, int dtype, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 0) {
        REPRO_BY_HEAD_DIM(bwd, float, q, k, v, out, dout, lse, delta, dq, dk,
                          dv, B, S, H, KVH, causal, window, scale, st)
    }
    REPRO_BY_HEAD_DIM(bwd, __nv_bfloat16, q, k, v, out, dout, lse, delta, dq,
                      dk, dv, B, S, H, KVH, causal, window, scale, st)
}
