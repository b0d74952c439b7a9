// Flash attention forward and backward for Hopper (sm_90a): bf16 storage
// on the tensor cores, f32 storage on the CUDA cores. Scores, softmax
// statistics and accumulators are f32 on both routes.
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
// Layout: q (B, S, H, D), k (B, S, KVH, D), v (B, S, KVH, Dv), out and
// dout (B, S, H, Dv); lse, delta (B, S, H) f32. Dv may differ from D (MLA:
// D 192 = 128 nope + 64 rope, Dv 128): S = Q.K^T and dQ, dK run over D, P.V,
// dP = dO.V^T, dV and delta over Dv, and the scale is 1/sqrt(D). Head h
// reads KV head h / (H / KVH): K and V are never expanded per query head
// (the reference's GQA wrapper repeats them).
// Masks: key < S, causal (query >= key), window (query - key < window;
// 0 = none). Masked scores are -1e30, not -inf, as in the reference.
//
// The arithmetic follows the reference's training path: s = (q.k) * scale
// in f32; online softmax per kv tile; p rounded to v's dtype before p.V;
// l sums the unrounded p; out = acc / max(l, 1e-30), lse = m + log(max(l,
// 1e-30)). Backward: p = exp(s - lse), dv += round(p)^T.dO, dp = dO.V^T,
// ds = p (dp - delta) scale, dq += round(ds).K, dk += round(ds)^T.Q,
// delta = sum(dO * O). On the bf16 route the rounding points are the
// tensor cores' bf16 A operands.
//
// Bound. At the training shapes (S 4096, D 256, H 8, KVH 4) each product
// does 2 D flops per unmasked (query, key) pair: about 2 S^2 D H under
// the causal mask, a quarter of that under the 1024 window. The forward
// has two products, the backward's bound five (s, dp, dv, dq, dk), against
// a few bytes per pair: the work is bound by operations, bf16 989 TFLOP/s
// on the H100's tensor cores.
//
// bf16 route (namespace tc):
//   forward  - one block per (128 query rows, head, batch): two consumer
//              warpgroups of 64 rows and one producer warpgroup. One
//              producer thread issues TMA copies (tensor maps whose 128-,
//              64- or 32-byte swizzle is the tiles' layout): Q once, then K
//              and V tiles of 64 keys into a ring of 2 stages, each
//              completing on its stage's `full` mbarrier; the consumers
//              arrive on its `empty` one when their products have read it.
//              Products: S = Q.K^T is wgmma m64n64k16 with both operands
//              K-major in shared memory; P.V is wgmma m64nDk16 with P
//              rounded to bf16 in registers as the A operand and V read
//              MN-major from shared memory. The mask (only on tiles that
//              cross the diagonal, the window edge or S) and the online
//              softmax (exp2, scale * log2 e folded into the scores) run in
//              registers; O stays in registers. Tiles wholly masked for a
//              warpgroup's rows are skipped; blocks run heaviest q tile
//              first. The 384 threads start at 168 registers (three warps
//              on each SM quarter); at D 256 setmaxnreg moves the producers
//              to 40 and the consumers to 232, since O alone takes 128.
//              Shared memory at D 256: Q 64 KB + 2 x (K 32 KB + V 32 KB).
//   backward - the delta kernel, then two passes with no atomics (two
//              calls give the same bits).
//              dK/dV: one block per (64 keys, KV head, batch) looping over
//              the G query heads and the q tiles in a fixed order (S, dP,
//              dV, dK). Every product is mma.sync m16n8k16 (bf16 in, f32
//              accumulate) with operands from swizzled shared memory by
//              ldmatrix (.trans for the transposed ones); Q and dO tiles
//              come through a 2-stage cp.async ring. mma.sync, not wgmma:
//              at D 256 the pass holds two 64 x 256 f32 accumulators (128
//              registers a thread over 8 warps, 256 over one warpgroup as
//              wgmma lays them out) beside S and dP, the layout
//              FlashAttention-2's hdim-256 backward fits on sm_90 (ptxas:
//              about 250 registers, no spills).
//              dQ: the forward's block (128 query rows, head, batch; a TMA
//              producer warpgroup, setmaxnreg at D 256) looping over K / V
//              tiles of 32 keys: S and dP are wgmma m64n32k16 from shared
//              memory, dQ += dS.K is wgmma m64nDk16 with dS rounded to
//              bf16 in registers and K read MN-major.
//              Seven products against the bound's five cap this design at
//              about 71 % of the bound.
// Tiles live in shared memory in wgmma's swizzled layout (sm90.cuh).
//
// Head dims 24 and 96 run on the next tile width up (32, 128), with the
// true D as the kernels' `dt`: global strides and offsets use dt; TMA maps
// span dt columns, so a box reads zeros at dt and past it; the cp.async
// and CUDA-core loads zero those columns; the stores of out, dq, dk and dv
// skip them. Zero columns add nothing to Q.K^T or dO.V^T and give zero
// columns of P.V, dS.K and dS^T.Q, so every product is the true-D one; the
// scale is 1/sqrt(dt). The padded columns cost their share of the work
// (a third at 96, a quarter at 24). The other instantiations fold dt to
// their tile width (tile_dt) and compile as they did without it.
//
// Every kernel is templated on two tile widths, DK for Q and K (and dQ,
// dK) and DV for V, O and dO (and dV), with the true widths dtk and dtv at
// run time. The equal pairs (DK == DV) take dtv = dtk and compile to the
// code of one width. MLA's pairs run D 192 on the 256-column Q/K tiles
// with Dv 128 on the 128-column V tiles, and the reduced D 24 / Dv 16 on
// the 32- and 16-column ones; K and V have their own TMA maps, swizzles
// and shared-memory tiles, and the Q.K^T products stop at the last k-step
// that holds a column below dtk (192: three of the four 64-column slabs),
// whose TMA copies alone are issued. The dQ products still run over all
// DK columns (wgmma's N is the tile); the columns past dtk read whatever
// the unloaded K slab holds and are never stored.
//
// f32 route (namespace simt): the first version, f32 FMA on the CUDA cores
// from f32 shared-memory tiles (row stride D + 1), the same blocks and
// passes with 64 x 64 forward and 32 x 32 backward tiles.
//
// The launchers allocate nothing, do not synchronise, and return
// cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// the head dim a kernel works on, D its tile width and DO the other
// operand's: only the 32- and 128-column tiles serve a narrower D (24, 96)
// among the equal pairs, so the others fold it to their constant tile
// width and compile as they would without it; an MLA pair (DK != DV)
// takes both dims at run time
template <int D, int DO> __device__ __forceinline__ int tile_dt(int dt) {
    return D == 32 || D == 128 || D != DO ? dt : D;
}

// dtk and dtv of a (DK, DV) kernel: an equal pair has one width
template <int DK, int DV>
__device__ __forceinline__ void tile_dts(int* dtk, int* dtv) {
    *dtk = tile_dt<DK, DV>(*dtk);
    *dtv = DK == DV ? *dtk : tile_dt<DV, DK>(*dtv);
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

namespace simt {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
    return x;
}
template <typename T> __device__ __forceinline__ float round_to(float x) {
    return to_f(from_f<T>(x));
}

// rows [r0, r0 + n) of one head of a (B, S, heads, dt) tensor -> f32 tile
// of D columns with row stride ld; rows at or past S and columns at or past
// dt are zero
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* base,
                                          long row_stride, int r0, int n,
                                          int S, int dt) {
    for (int i = threadIdx.x; i < n * D; i += kThreads) {
        const int r = i / D, c = i % D;
        dst[r * ld + c] = r0 + r < S && c < dt
                              ? to_f(base[(long)(r0 + r) * row_stride + c])
                              : 0.f;
    }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ out,
                float* __restrict__ lse, int S, int H, int KVH, int causal,
                int window, float scale, int dtk, int dtv) {
    tile_dts<DK, DV>(&dtk, &dtv);
    constexpr int BQ = 64, BK = 64, QS = DK + 1, SS = BK + 1;
    constexpr int RP = BQ * DV / kThreads;    // output rows per thread
    extern __shared__ float smem[];
    float* q_s = smem;                        // [BQ][QS]
    float* k_s = q_s + BQ * QS;               // [BK][QS]
    float* v_s = k_s + BK * QS;               // [BK][DV]
    float* s_s = v_s + BK * DV;               // [BQ][SS]
    float* m_s = s_s + BQ * SS;               // [BQ] running max
    float* l_s = m_s + BQ;                    // [BQ] running sum
    float* c_s = l_s + BQ;                    // [BQ] this tile's correction

    const int tid = threadIdx.x;
    const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
    const int kvh = h / (H / KVH);
    const long qrs = (long)H * dtk, krs = (long)KVH * dtk;
    const long vrs = (long)KVH * dtv, ors = (long)H * dtv;
    const T* qb = q + (long)b * S * qrs + (long)h * dtk;
    const T* kb = k + (long)b * S * krs + (long)kvh * dtk;
    const T* vb = v + (long)b * S * vrs + (long)kvh * dtv;

    load_rows<T, DK>(q_s, QS, qb, qrs, q0, BQ, S, dtk);
    if (tid < BQ) {
        m_s[tid] = kNegInf;
        l_s[tid] = 0.f;
    }
    // output accumulator: column oc, rows orow .. orow + RP
    const int oc = tid % DV, orow = (tid / DV) * RP;
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
        load_rows<T, DK>(k_s, QS, kb, krs, k0, BK, S, dtk);
        load_rows<T, DV>(v_s, DV, vb, vrs, k0, BK, S, dtv);
        __syncthreads();
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int n = 0; n < 4; ++n) acc[i][n] = 0.f;
#pragma unroll 4
        for (int d = 0; d < DK; ++d) {
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
            const float vv = v_s[j * DV + oc];
#pragma unroll
            for (int i = 0; i < RP; ++i)
                o[i] = fmaf(s_s[(orow + i) * SS + j], vv, o[i]);
        }
    }
    __syncthreads();
    T* ob = out + (long)b * S * ors + (long)h * dtv;
#pragma unroll
    for (int i = 0; i < RP; ++i) {
        const int r = orow + i;
        if (q0 + r < S && oc < dtv)
            ob[(long)(q0 + r) * ors + oc] =
                from_f<T>(o[i] / fmaxf(l_s[r], 1e-30f));
    }
    if (tid < BQ && q0 + tid < S)
        lse[((long)b * S + q0 + tid) * H + h] =
            m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// delta = sum over Dv of dout * out, one warp per (b, s, h) row
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
// sj + 8 n. q_s and k_s have row stride DK + 1, o_s (dO) and v_s DV + 1.
// Writes round(p) to p_s (when given) and round(ds) to ds_s.
template <typename T, int DK, int DV>
__device__ __forceinline__ void bwd_tile(const float* q_s, const float* o_s,
                                         const float* k_s, const float* v_s,
                                         const float* lse_s,
                                         const float* dl_s, float* p_s,
                                         float* ds_s, int q0, int k0, int S,
                                         int causal, int window,
                                         float scale) {
    constexpr int QS = DK + 1, VS = DV + 1, SS = 32 + 1;
    const int si = threadIdx.x / 8, sj = threadIdx.x % 8;
    float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (DK == DV) {
#pragma unroll 4
        for (int d = 0; d < DK; ++d) {
            const float a = q_s[si * QS + d], g = o_s[si * VS + d];
#pragma unroll
            for (int n = 0; n < 4; ++n) {
                s[n] = fmaf(a, k_s[(sj + 8 * n) * QS + d], s[n]);
                dp[n] = fmaf(g, v_s[(sj + 8 * n) * VS + d], dp[n]);
            }
        }
    } else {
#pragma unroll 4
        for (int d = 0; d < DK; ++d) {
            const float a = q_s[si * QS + d];
#pragma unroll
            for (int n = 0; n < 4; ++n)
                s[n] = fmaf(a, k_s[(sj + 8 * n) * QS + d], s[n]);
        }
#pragma unroll 4
        for (int d = 0; d < DV; ++d) {
            const float g = o_s[si * VS + d];
#pragma unroll
            for (int n = 0; n < 4; ++n)
                dp[n] = fmaf(g, v_s[(sj + 8 * n) * VS + d], dp[n]);
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

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int H, int KVH, int causal,
                     int window, float scale, int dtk, int dtv) {
    tile_dts<DK, DV>(&dtk, &dtv);
    constexpr int BQ = 32, BK = 32, QS = DK + 1, VS = DV + 1, SS = BK + 1;
    constexpr int RPK = BK * DK / kThreads;   // dk rows per thread
    constexpr int RPV = BK * DV / kThreads;   // dv rows per thread
    extern __shared__ float smem[];
    float* k_s = smem;                        // [BK][QS]
    float* v_s = k_s + BK * QS;               // [BK][VS]
    float* q_s = v_s + BK * VS;               // [BQ][QS]
    float* o_s = q_s + BQ * QS;               // [BQ][VS] dout
    float* p_s = o_s + BQ * VS;               // [BQ][SS]
    float* ds_s = p_s + BQ * SS;              // [BQ][SS]
    float* lse_s = ds_s + BQ * SS;            // [BQ]
    float* dl_s = lse_s + BQ;                 // [BQ]

    const int tid = threadIdx.x;
    const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
    const int G = H / KVH;
    const long qrs = (long)H * dtk, krs = (long)KVH * dtk;
    const long vrs = (long)KVH * dtv, ors = (long)H * dtv;
    const T* kb = k + (long)b * S * krs + (long)kvh * dtk;
    const T* vb = v + (long)b * S * vrs + (long)kvh * dtv;
    load_rows<T, DK>(k_s, QS, kb, krs, k0, BK, S, dtk);
    load_rows<T, DV>(v_s, VS, vb, vrs, k0, BK, S, dtv);

    const int ack = tid % DK, arowk = (tid / DK) * RPK;
    const int acv = tid % DV, arowv = (tid / DV) * RPV;
    float dka[RPK], dva[RPV];
#pragma unroll
    for (int i = 0; i < RPK; ++i) dka[i] = 0.f;
#pragma unroll
    for (int i = 0; i < RPV; ++i) dva[i] = 0.f;

    int lo, hi;
    q_range(k0, min(k0 + BK, S), S, BQ, causal, window, &lo, &hi);
    for (int g = 0; g < G; ++g) {
        const int h = kvh * G + g;
        const T* qb = q + (long)b * S * qrs + (long)h * dtk;
        const T* ob = dout + (long)b * S * ors + (long)h * dtv;
        for (int it = lo; it < hi; ++it) {
            const int q0 = it * BQ;
            __syncthreads();
            load_rows<T, DK>(q_s, QS, qb, qrs, q0, BQ, S, dtk);
            load_rows<T, DV>(o_s, VS, ob, ors, q0, BQ, S, dtv);
            if (tid < BQ) {
                const bool ok = q0 + tid < S;
                const long at = ((long)b * S + q0 + tid) * H + h;
                lse_s[tid] = ok ? lse[at] : 0.f;
                dl_s[tid] = ok ? delta[at] : 0.f;
            }
            __syncthreads();
            bwd_tile<T, DK, DV>(q_s, o_s, k_s, v_s, lse_s, dl_s, p_s, ds_s,
                                q0, k0, S, causal, window, scale);
            __syncthreads();
            if constexpr (DK == DV) {
                for (int i = 0; i < BQ; ++i) {
                    const float gv = o_s[i * VS + acv];
                    const float qv = q_s[i * QS + ack];
#pragma unroll
                    for (int r = 0; r < RPK; ++r) {
                        dva[r] = fmaf(p_s[i * SS + arowv + r], gv, dva[r]);
                        dka[r] = fmaf(ds_s[i * SS + arowk + r], qv, dka[r]);
                    }
                }
            } else {
                for (int i = 0; i < BQ; ++i) {
                    const float gv = o_s[i * VS + acv];
                    const float qv = q_s[i * QS + ack];
#pragma unroll
                    for (int r = 0; r < RPV; ++r)
                        dva[r] = fmaf(p_s[i * SS + arowv + r], gv, dva[r]);
#pragma unroll
                    for (int r = 0; r < RPK; ++r)
                        dka[r] = fmaf(ds_s[i * SS + arowk + r], qv, dka[r]);
                }
            }
        }
    }
    T* dkb = dk + (long)b * S * krs + (long)kvh * dtk;
    T* dvb = dv + (long)b * S * vrs + (long)kvh * dtv;
    if constexpr (DK == DV) {
#pragma unroll
        for (int r = 0; r < RPK; ++r) {
            const int s = k0 + arowk + r;
            if (s < S && ack < dtk) {
                dkb[(long)s * krs + ack] = from_f<T>(dka[r]);
                dvb[(long)s * vrs + acv] = from_f<T>(dva[r]);
            }
        }
    } else {
#pragma unroll
        for (int r = 0; r < RPK; ++r) {
            const int s = k0 + arowk + r;
            if (s < S && ack < dtk)
                dkb[(long)s * krs + ack] = from_f<T>(dka[r]);
        }
#pragma unroll
        for (int r = 0; r < RPV; ++r) {
            const int s = k0 + arowv + r;
            if (s < S && acv < dtv)
                dvb[(long)s * vrs + acv] = from_f<T>(dva[r]);
        }
    }
}

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq, int S,
                   int H, int KVH, int causal, int window, float scale,
                   int dtk, int dtv) {
    tile_dts<DK, DV>(&dtk, &dtv);
    constexpr int BQ = 32, BK = 32, QS = DK + 1, VS = DV + 1, SS = BK + 1;
    constexpr int RP = BQ * DK / kThreads;    // dq rows per thread
    extern __shared__ float smem[];
    float* q_s = smem;                        // [BQ][QS]
    float* o_s = q_s + BQ * QS;               // [BQ][VS] dout
    float* k_s = o_s + BQ * VS;               // [BK][QS]
    float* v_s = k_s + BK * QS;               // [BK][VS]
    float* ds_s = v_s + BK * VS;              // [BQ][SS]
    float* lse_s = ds_s + BQ * SS;            // [BQ]
    float* dl_s = lse_s + BQ;                 // [BQ]

    const int tid = threadIdx.x;
    const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
    const int kvh = h / (H / KVH);
    const long qrs = (long)H * dtk, krs = (long)KVH * dtk;
    const long vrs = (long)KVH * dtv, ors = (long)H * dtv;
    const T* kb = k + (long)b * S * krs + (long)kvh * dtk;
    const T* vb = v + (long)b * S * vrs + (long)kvh * dtv;
    load_rows<T, DK>(q_s, QS, q + (long)b * S * qrs + (long)h * dtk, qrs, q0,
                     BQ, S, dtk);
    load_rows<T, DV>(o_s, VS, dout + (long)b * S * ors + (long)h * dtv, ors,
                     q0, BQ, S, dtv);
    if (tid < BQ) {
        const bool ok = q0 + tid < S;
        const long at = ((long)b * S + q0 + tid) * H + h;
        lse_s[tid] = ok ? lse[at] : 0.f;
        dl_s[tid] = ok ? delta[at] : 0.f;
    }
    const int ac = tid % DK, arow = (tid / DK) * RP;
    float dqa[RP];
#pragma unroll
    for (int i = 0; i < RP; ++i) dqa[i] = 0.f;

    int lo, hi;
    kv_range(q0, min(q0 + BQ, S), S, BK, causal, window, &lo, &hi);
    for (int jt = lo; jt < hi; ++jt) {
        const int k0 = jt * BK;
        __syncthreads();
        load_rows<T, DK>(k_s, QS, kb, krs, k0, BK, S, dtk);
        load_rows<T, DV>(v_s, VS, vb, vrs, k0, BK, S, dtv);
        __syncthreads();
        bwd_tile<T, DK, DV>(q_s, o_s, k_s, v_s, lse_s, dl_s, nullptr, ds_s,
                            q0, k0, S, causal, window, scale);
        __syncthreads();
        for (int j = 0; j < BK; ++j) {
            const float kv = k_s[j * QS + ac];
#pragma unroll
            for (int r = 0; r < RP; ++r)
                dqa[r] = fmaf(ds_s[(arow + r) * SS + j], kv, dqa[r]);
        }
    }
    T* dqb = dq + (long)b * S * qrs + (long)h * dtk;
#pragma unroll
    for (int r = 0; r < RP; ++r) {
        const int s = q0 + arow + r;
        if (s < S && ac < dtk) dqb[(long)s * qrs + ac] = from_f<T>(dqa[r]);
    }
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16 route: tensor cores
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// forward: 128 query rows of one head a block (two consumer warpgroups of
// 64), kv tiles of 64 keys in a ring of 2 stages, one producer warpgroup
constexpr int kFwdRows = 64, kFwdBK = 64, kStages = 2;
constexpr int kConsumers = 256, kProducers = 128;
constexpr int kFwdThreads = kConsumers + kProducers;
// 384 threads start with 168 registers each (each SM quarter holds three
// warps); where the accumulator is 256 columns wide (O of the forward at
// DV 256, dQ at DK 256) the producers give 128 of theirs to the consumers,
// whose accumulator alone takes 128 (168 would spill it)
constexpr int kFwdRegs = 168, kProducerRegs = 40, kConsumerRegs = 232;
template <int N> constexpr bool kMoveRegs = N == 256;

template <int DK, int DV> struct FwdSmem {
    static constexpr int kQ = kFwdRows * DK * 2;       // a warpgroup's Q
    static constexpr int kK = kFwdBK * DK * 2;         // one K tile
    static constexpr int kV = kFwdBK * DV * 2;         // one V tile
    static constexpr int kBarriers = 2 * kQ + kStages * (kK + kV);
    // + the mbarriers, + slack to align the base to 1024 bytes
    static constexpr size_t kAlloc = kBarriers + 8 * (2 * kStages + 1) + 1024;
};

// s = A . B^T for one warpgroup: A a 64-row tile (Q or dO), B a BK-row
// tile (K or V), D / 16 wgmma k-steps, both K-major in shared memory.
// kRagged (an MLA pair's Q.K^T): stop after the last k-step that holds a
// column below dt; the zero columns past it add nothing.
template <int D, int BK, bool kRagged = false>
__device__ __forceinline__ void issue_scores(float* s, uint32_t qa,
                                             uint32_t ks, int dt = D) {
    using Sw = Swz<D>;
    constexpr int RB = Sw::kRowBytes, KPR = RB / 32;   // k-steps a row
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
        if (kRagged && 16 * kk >= dt) break;
        const uint32_t at = (kk / KPR) * kFwdRows * RB + (kk % KPR) * 32;
        const uint32_t bt = (kk / KPR) * BK * RB + (kk % KPR) * 32;
        WgmmaSS<BK>::run(s, wgmma_desc(qa + at, 16, 8 * RB, Sw::kLayout),
                         wgmma_desc(ks + bt, 16, 8 * RB, Sw::kLayout), 1);
    }
}

// o += P . V: P (64 x BK) as BK / 16 bf16 A fragments, V (or K) a BK-row
// tile read MN-major from shared memory (D-wide slabs BK * RB apart)
template <int D, int BK>
__device__ __forceinline__ void issue_pv(float* o, const uint32_t (*pa)[4],
                                         uint32_t vs) {
    using Sw = Swz<D>;
    constexpr int RB = Sw::kRowBytes;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
        WgmmaRS<D>::run(o, pa[kk],
                        wgmma_desc(vs + kk * 16 * RB, BK * RB, 8 * RB,
                                   Sw::kLayout),
                        1);
}

// the online softmax of one tile on this thread's scores (rows r0, r1;
// keys k0 + 8 n + 2 t + {0, 1}): s becomes the unrounded p, m the new
// running max (log2 domain), c the correction of the old state, ps this
// tile's partial row sums. kMask (a tile that crosses the diagonal, the
// window edge or S): x = s scale log2 e, -1e30 where masked, p = exp2(x -
// m), so x - m stays finite when a whole row is masked. Otherwise every
// score is finite and p = exp2(s scale log2 e - m) in one FMA.
template <bool kMask>
__device__ __forceinline__ void tile_softmax(float* s, int k0, int r0,
                                             int r1, int t, int S,
                                             int causal, int window,
                                             float scale_log2, float* m,
                                             float* c, float* ps) {
    float mx[2] = {kNegInf, kNegInf};
    if (kMask) {
        // keys [lo, hi) of each row, relative to this thread's first key
        int lo[2], hi[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int r = i ? r1 : r0, k = k0 + 2 * t;
            lo[i] = (window ? r - window + 1 : 0) - k;
            hi[i] = min(S, causal ? r + 1 : S) - k;
        }
#pragma unroll
        for (int n = 0; n < kFwdBK / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int key = 8 * n + (e & 1), i = e / 2;
                const float x = key >= lo[i] && key < hi[i]
                                    ? s[4 * n + e] * scale_log2
                                    : kNegInf;
                s[4 * n + e] = x;
                mx[i] = fmaxf(mx[i], x);
            }
    } else {
#pragma unroll
        for (int n = 0; n < kFwdBK / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                mx[e / 2] = fmaxf(mx[e / 2], s[4 * n + e]);
    }
    float mm[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float mn = fmaxf(m[i], kMask ? mx[i] : mx[i] * scale_log2);
        c[i] = exp2f(m[i] - mn);
        m[i] = mn;
        mm[i] = -mn;
        ps[i] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < kFwdBK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float x = s[4 * n + e];
            s[4 * n + e] = kMask ? exp2f(x + mm[e / 2])
                                 : exp2f(fmaf(x, scale_log2, mm[e / 2]));
            ps[e / 2] += s[4 * n + e];
        }
}

// p (this thread's scores of a 64 x BK tile) rounded to bf16 as the A
// fragments of BK / 16 k16 steps: n8 block n holds keys 8 n + 2 t
template <int BK = kFwdBK>
__device__ __forceinline__ void pack_p(const float* s, uint32_t (*pa)[4]) {
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
        pa[n / 2][(n % 2) * 2] = pack_bf16(s[4 * n], s[4 * n + 1]);
        pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(s[4 * n + 2], s[4 * n + 3]);
    }
}

template <int DK, int DV>
__global__ void __launch_bounds__(kFwdThreads, 1)
attn_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                bf16* __restrict__ out, float* __restrict__ lse, int S, int H,
                int KVH, int causal, int window, float scale_log2, int dtk,
                int dtv) {
    tile_dts<DK, DV>(&dtk, &dtv);
    using L = FwdSmem<DK, DV>;
    constexpr int BK = kFwdBK;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* sm = aligned_smem(smem_raw);
    const uint32_t q_s = smem_u32(sm);        // warpgroup u: q_s + u kQ
    const uint32_t kv_s = q_s + 2 * L::kQ;    // stage st: K, then V
    constexpr int kStage = L::kK + L::kV;
    uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBarriers);
    uint64_t* empty = full + kStages;
    uint64_t* q_full = empty + kStages;

    const int tid = threadIdx.x;
    // blocks in launch order: q tiles from the last (the heaviest under
    // the causal mask), all heads of one q tile together
    const int q0 = (gridDim.x / H - 1 - blockIdx.x / H) * 2 * kFwdRows;
    const int h = blockIdx.x % H, b = blockIdx.y, kvh = h / (H / KVH);
    const long ors = (long)H * dtv;
    int lo, hi;
    kv_range(q0, min(q0 + 2 * kFwdRows, S), S, BK, causal, window, &lo, &hi);

    if (tid == 0) {
        for (int s = 0; s < kStages; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], kConsumers);
        }
        mbar_init(q_full, 1);
        mbar_fence_init();
    }
    __syncthreads();

    if (tid >= kConsumers) {
        // producer warpgroup: one thread issues the TMA copies, Q once and
        // then the K / V ring, each slab of 64 columns one box of 64 rows
        // (rows past S come back zero)
        if constexpr (kMoveRegs<DV>)
            asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                         :: "n"(kProducerRegs));
        if (tid != kConsumers) return;
        using SK = Swz<DK>;
        using SV = Swz<DV>;
        constexpr int kSlabs = DK / SK::kSlabCols;
        constexpr int kSlab = kFwdRows * SK::kRowBytes;       // bytes
        constexpr int kVSlabs = DV / SV::kSlabCols;
        constexpr int kVSlab = kFwdBK * SV::kRowBytes;
        // an MLA pair loads the Q / K slabs that hold a column below dtk:
        // the products stop there (issue_scores)
        const int qk_slabs = DK == DV ? kSlabs
                                      : (dtk + SK::kSlabCols - 1) /
                                            SK::kSlabCols;
        mbar_expect_tx(q_full, 2 * qk_slabs * kSlab);
        for (int u = 0; u < 2; ++u)
            for (int c = 0; c < qk_slabs; ++c)
                tma_load_4d(q_s + u * L::kQ + c * kSlab, &tm_q,
                            c * SK::kSlabCols, h, q0 + u * kFwdRows, b,
                            q_full);
        for (int j = lo; j < hi; ++j) {
            const int it = j - lo, st = it % kStages;
            if (it >= kStages) mbar_wait(&empty[st], (it / kStages - 1) & 1);
            const uint32_t ks = kv_s + st * kStage;
            mbar_expect_tx(&full[st], qk_slabs * kSlab + L::kV);
            if constexpr (DK == DV) {
                for (int c = 0; c < kSlabs; ++c) {
                    tma_load_4d(ks + c * kSlab, &tm_k, c * SK::kSlabCols, kvh,
                                j * BK, b, &full[st]);
                    tma_load_4d(ks + L::kK + c * kSlab, &tm_v,
                                c * SK::kSlabCols, kvh, j * BK, b, &full[st]);
                }
            } else {
                for (int c = 0; c < qk_slabs; ++c)
                    tma_load_4d(ks + c * kSlab, &tm_k, c * SK::kSlabCols, kvh,
                                j * BK, b, &full[st]);
                for (int c = 0; c < kVSlabs; ++c)
                    tma_load_4d(ks + L::kK + c * kVSlab, &tm_v,
                                c * SV::kSlabCols, kvh, j * BK, b, &full[st]);
            }
        }
        return;
    }

    // consumer warpgroup wg; this thread's rows r0, r1
    if constexpr (kMoveRegs<DV>)
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                     :: "n"(kConsumerRegs));
    const int wg = tid / 128, w = (tid % 128) / 32, lane = tid % 32;
    const int t = lane % 4;
    const int qw = q0 + wg * kFwdRows;
    const int r0 = qw + w * 16 + lane / 4, r1 = r0 + 8;
    const uint32_t qa = q_s + wg * L::kQ;
    auto stage = [&](int j) { return kv_s + (j - lo) % kStages * kStage; };
    auto edge = [&](int k0) {   // does the tile cross a mask edge here?
        return k0 + BK > S || (causal && k0 + BK - 1 > qw) ||
               (window && qw + 63 - k0 >= window);
    };
    float o[DV / 2], s[BK / 2];
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, c[2], ps[2];
    mbar_wait(q_full, 0);

    for (int j = lo; j < hi; ++j) {
        const int it = j - lo, k0 = j * BK;
        mbar_wait(&full[it % kStages], (it / kStages) & 1);
        // tiles wholly masked for this warpgroup's rows are skipped
        const bool skip = qw >= S || (causal && k0 > qw + 63) ||
                          (window && qw - (k0 + BK - 1) >= window);
        if (!skip) {
#pragma unroll
            for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
            fence_regs<BK / 2>(s);
            wgmma_fence();
            issue_scores<DK, BK, DK != DV>(s, qa, stage(j), dtk);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs<BK / 2>(s);
            if (edge(k0))
                tile_softmax<true>(s, k0, r0, r1, t, S, causal, window,
                                   scale_log2, m, c, ps);
            else
                tile_softmax<false>(s, k0, r0, r1, t, S, causal, window,
                                    scale_log2, m, c, ps);
            // o * 1 is o: skip the rescale when no row of the warp moved
            if (__any_sync(0xffffffffu, c[0] != 1.f || c[1] != 1.f)) {
#pragma unroll
                for (int n = 0; n < DV / 8; ++n) {
                    o[4 * n] *= c[0];
                    o[4 * n + 1] *= c[0];
                    o[4 * n + 2] *= c[1];
                    o[4 * n + 3] *= c[1];
                }
            }
            l[0] = l[0] * c[0] + ps[0];
            l[1] = l[1] * c[1] + ps[1];
            pack_p(s, pa);
            fence_regs<DV / 2>(o);
            wgmma_fence();
            issue_pv<DV, BK>(o, pa, stage(j) + L::kK);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs<DV / 2>(o);
        }
        mbar_arrive(&empty[it % kStages]);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        l[i] = fmaxf(l[i], 1e-30f);
    }
    bf16* ob = out + (long)b * S * ors + (long)h * dtv;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
        const int col = 8 * n + 2 * t;
        if (col >= dtv) continue;
        if (r0 < S)
            *reinterpret_cast<uint32_t*>(ob + (long)r0 * ors + col) =
                pack_bf16(o[4 * n] / l[0], o[4 * n + 1] / l[0]);
        if (r1 < S)
            *reinterpret_cast<uint32_t*>(ob + (long)r1 * ors + col) =
                pack_bf16(o[4 * n + 2] / l[1], o[4 * n + 3] / l[1]);
    }
    if (t == 0) {
        if (r0 < S)
            lse[((long)b * S + r0) * H + h] = m[0] * kLn2 + logf(l[0]);
        if (r1 < S)
            lse[((long)b * S + r1) * H + h] = m[1] * kLn2 + logf(l[1]);
    }
}

// backward: 64 x 64 tiles, 8 warps
constexpr int kBwdB = 64, kBwdThreads = 256;

template <int DK, int DV> struct BwdSmem {
    static constexpr int kTileK = kBwdB * DK * 2;        // 64 rows of DK
    static constexpr int kTileV = kBwdB * DV * 2;        // 64 rows of DV
    static constexpr int kScore = kBwdB * kBwdB * 2;     // a 64 x 64 bf16 tile
    // resident K and V, a ring of 2 stages x (Q, dO), P and dS
    static constexpr size_t kAlloc =
        3 * (kTileK + kTileV) + 2 * kScore + 1024;
};

// S = Q.K^T and dP = dO.V^T for this warp's 16 query rows [16 wr, + 16)
// and 32 keys [32 wc, + 32) of a 64 x 64 tile pair; sa, da: 4 n8 blocks.
// An MLA pair runs the two products as two loops, S over the k-steps that
// hold a column below dtk.
template <int DK, int DV>
__device__ __forceinline__ void scores(uint32_t q_s, uint32_t o_s,
                                       uint32_t k_s, uint32_t v_s, int wr,
                                       int wc, int lane, float (*sa)[4],
                                       float (*da)[4], int dtk) {
    using Sw = Swz<DK>;
    using Sv = Swz<DV>;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sa[n][e] = da[n][e] = 0.f;
    const int ar = 16 * wr + lane % 16, ac = lane / 16;
    const int br = 32 * wc + lane % 8 + (lane / 16) * 8, bc = (lane / 8) % 2;
    if constexpr (DK != DV) {
#pragma unroll 4
        for (int kk = 0; kk < DK / 16; ++kk) {
            if (16 * kk >= dtk) break;
            uint32_t aq[4];
            ldsm_x4(aq, q_s + Sw::template off<kBwdB>(ar, 2 * kk + ac));
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                uint32_t bk[4];
                ldsm_x4(bk, k_s + Sw::template off<kBwdB>(br + 16 * h,
                                                          2 * kk + bc));
                mma_bf16(sa[2 * h], aq, bk[0], bk[1]);
                mma_bf16(sa[2 * h + 1], aq, bk[2], bk[3]);
            }
        }
#pragma unroll 4
        for (int kk = 0; kk < DV / 16; ++kk) {
            uint32_t ao[4];
            ldsm_x4(ao, o_s + Sv::template off<kBwdB>(ar, 2 * kk + ac));
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                uint32_t bv[4];
                ldsm_x4(bv, v_s + Sv::template off<kBwdB>(br + 16 * h,
                                                          2 * kk + bc));
                mma_bf16(da[2 * h], ao, bv[0], bv[1]);
                mma_bf16(da[2 * h + 1], ao, bv[2], bv[3]);
            }
        }
        return;
    }
#pragma unroll 4
    for (int kk = 0; kk < DK / 16; ++kk) {
        uint32_t aq[4], ao[4];
        ldsm_x4(aq, q_s + Sw::template off<kBwdB>(ar, 2 * kk + ac));
        ldsm_x4(ao, o_s + Sw::template off<kBwdB>(ar, 2 * kk + ac));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            uint32_t bk[4], bv[4];
            ldsm_x4(bk, k_s + Sw::template off<kBwdB>(br + 16 * h,
                                                      2 * kk + bc));
            ldsm_x4(bv, v_s + Sw::template off<kBwdB>(br + 16 * h,
                                                      2 * kk + bc));
            mma_bf16(sa[2 * h], aq, bk[0], bk[1]);
            mma_bf16(sa[2 * h + 1], aq, bk[2], bk[3]);
            mma_bf16(da[2 * h], ao, bv[0], bv[1]);
            mma_bf16(da[2 * h + 1], ao, bv[2], bv[3]);
        }
    }
}

// The accumulating products (dV, dK: 64 rows x D, k = 64): warp w
// owns kMB m16 blocks from row m0 and kNB n8 blocks from column n0. Wider
// warp tiles at D >= 64 (32 rows x D / 4) read a third less shared memory
// than 16 x D / 2; the small head dims keep n8 blocks whole.
template <int D> struct AccTile {
    static constexpr int kMB = D >= 64 ? 2 : 1;
    static constexpr int kRowWarps = 4 / kMB;
    static constexpr int kNB = D / 16 / kMB;
    static __device__ __forceinline__ int m0(int w) {
        return 16 * kMB * (w % kRowWarps);
    }
    static __device__ __forceinline__ int n0(int w) {
        return (w / kRowWarps) * 8 * kNB;
    }
};

// acc (this warp's AccTile block) += A^T (64 x 64) . B (64 x D): A a 64 x
// 64 score tile stored [k][m] (P or dS by query row), B a D-wide tile
// stored [k][n].
template <int D>
__device__ __forceinline__ void acc_product(float (*acc)[4], uint32_t a_s,
                                            uint32_t b_s, int m0, int n0,
                                            int lane) {
    using Sa = Swz<kBwdB>;
    using Sb = Swz<D>;
    constexpr int MB = AccTile<D>::kMB, NB = AccTile<D>::kNB;
#pragma unroll
    for (int kk = 0; kk < kBwdB / 16; ++kk) {
        uint32_t a[MB][4];
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
            ldsm_x4_t(a[mb], a_s + Sa::template off<kBwdB>(
                                 16 * kk + lane % 8 + (lane / 16) * 8,
                                 (m0 + 16 * mb) / 8 + (lane / 8) % 2));
        const int br = 16 * kk + lane % 8 + ((lane / 8) % 2) * 8;
#pragma unroll
        for (int nb = 0; nb < NB; nb += 2) {
            uint32_t b[4];
            // for NB == 1 the upper two matrices repeat the lower two
            const int c = n0 / 8 + nb + (NB > 1 ? lane / 16 : 0);
            ldsm_x4_t(b, b_s + Sb::template off<kBwdB>(br, c));
#pragma unroll
            for (int mb = 0; mb < MB; ++mb) {
                mma_bf16(acc[mb * NB + nb], a[mb], b[0], b[1]);
                if (nb + 1 < NB)
                    mma_bf16(acc[mb * NB + nb + 1], a[mb], b[2], b[3]);
            }
        }
    }
}

// round(x) of this warp's S-layout fragment into a 64 x 64 bf16 tile
__device__ __forceinline__ void store_scores(uint32_t tile, int row, int col,
                                             float lo, float hi) {
    const uint32_t a = tile + Swz<kBwdB>::template off<kBwdB>(row, col / 8) +
                       (col % 8) * 2;
    asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(a),
                 "r"(pack_bf16(lo, hi)) : "memory");
}

// acc (this warp's AccTile block) -> rows [row0, + 64) of a (B, S,
// heads, dt) tensor, rows at or past S and columns at or past dt dropped
template <int D>
__device__ __forceinline__ void store_acc(bf16* base, long stride, int row0,
                                          int w, int S, int dt, int lane,
                                          const float (*acc)[4]) {
    using A = AccTile<D>;
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int mb = 0; mb < A::kMB; ++mb)
#pragma unroll
        for (int nb = 0; nb < A::kNB; ++nb) {
            const float* x = acc[mb * A::kNB + nb];
            const int r = row0 + A::m0(w) + 16 * mb + g;
            const int c = A::n0(w) + 8 * nb + 2 * t;
            if (c >= dt) continue;
            if (r < S)
                *reinterpret_cast<uint32_t*>(base + (long)r * stride + c) =
                    pack_bf16(x[0], x[1]);
            if (r + 8 < S)
                *reinterpret_cast<uint32_t*>(base + (long)(r + 8) * stride +
                                             c) = pack_bf16(x[2], x[3]);
        }
}

// lse log2 e and delta of this thread's two score rows, q0 + 16 wr + g
// (+ 8)
__device__ __forceinline__ void row_stats(const float* lse_b,
                                          const float* delta_b, int q0,
                                          int wr, int lane, int S, int H,
                                          float* ls, float* dl) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int r = q0 + 16 * wr + lane / 4 + 8 * i;
        ls[i] = r < S ? lse_b[(long)r * H] * kLog2e : 0.f;
        dl[i] = r < S ? delta_b[(long)r * H] : 0.f;
    }
}

// p = exp(s scale - lse) and ds = p (dp - delta) scale on this warp's
// scores, zero where masked or past S (kMask: a tile that crosses an
// edge); round(p) and round(ds) into their tiles. ls holds lse log2 e: p =
// exp2(s scale log2 e - ls).
template <bool kMask>
__device__ __forceinline__ void softmax_grad(
    float (*sa)[4], float (*da)[4], uint32_t p_s, uint32_t ds_s, int q0,
    int k0, int wr, int wc, int lane, const float* ls, const float* dl,
    int S, int causal, int window, float scale) {
    const int g = lane / 4, t = lane % 4;
    const float scale_log2 = scale * kLog2e;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
        const int col = 32 * wc + 8 * n + 2 * t;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int row = 16 * wr + g + 8 * i;
            float p[2], ds[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                p[e] = exp2f(fmaf(sa[n][2 * i + e], scale_log2, -ls[i]));
                if (kMask && !(q0 + row < S && allowed(q0 + row, k0 + col + e,
                                                       S, causal, window)))
                    p[e] = 0.f;
                ds[e] = p[e] * (da[n][2 * i + e] - dl[i]) * scale;
            }
            store_scores(p_s, row, col, p[0], p[1]);
            store_scores(ds_s, row, col, ds[0], ds[1]);
        }
    }
}

// does the 64 x 64 tile at (q0, k0) cross the diagonal, the window edge
// or S?
__device__ __forceinline__ bool tile_edge(int q0, int k0, int S, int causal,
                                          int window) {
    return q0 + kBwdB > S || k0 + kBwdB > S ||
           (causal && k0 + kBwdB - 1 > q0) ||
           (window && q0 + kBwdB - 1 - k0 >= window);
}

template <int DK, int DV>
__global__ void __launch_bounds__(kBwdThreads, 1)
attn_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int S, int H, int KVH, int causal,
                     int window, float scale, int dtk, int dtv) {
    tile_dts<DK, DV>(&dtk, &dtv);
    using L = BwdSmem<DK, DV>;
    constexpr int BQ = kBwdB, BK = kBwdB;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t k_s = smem_u32(aligned_smem(smem_raw));
    const uint32_t v_s = k_s + L::kTileK;
    const uint32_t ring = v_s + L::kTileV;        // stage st: Q, then dO
    constexpr int kStage = L::kTileK + L::kTileV;
    const uint32_t p_s = ring + 2 * kStage, ds_s = p_s + L::kScore;

    const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
    const int wr = w % 4, wc = w / 4;
    // kv tiles from the first (the heaviest under the causal mask)
    const int k0 = blockIdx.x / KVH * BK, kvh = blockIdx.x % KVH;
    const int b = blockIdx.y;
    const int G = H / KVH;
    const long qrs = (long)H * dtk, krs = (long)KVH * dtk;
    const long vrs = (long)KVH * dtv, ors = (long)H * dtv;
    const bf16* kb = k + (long)b * S * krs + (long)kvh * dtk;
    const bf16* vb = v + (long)b * S * vrs + (long)kvh * dtv;
    copy_tile<BK, DK, kBwdThreads>(k_s, kb, krs, k0, S, dtk, tid);
    copy_tile<BK, DV, kBwdThreads>(v_s, vb, vrs, k0, S, dtv, tid);

    int lo, hi;
    q_range(k0, min(k0 + BK, S), S, BQ, causal, window, &lo, &hi);
    const int nqt = hi - lo, n = G * nqt;
    // tile x of the fixed order: head kvh G + x / nqt, q tile lo + x % nqt
    auto issue = [&](int x) {
        const int h = kvh * G + x / nqt, q0 = (lo + x % nqt) * BQ;
        const uint32_t st = ring + (x % 2) * kStage;
        copy_tile<BQ, DK, kBwdThreads>(st, q + (long)b * S * qrs +
                                       (long)h * dtk, qrs, q0, S, dtk, tid);
        copy_tile<BQ, DV, kBwdThreads>(st + L::kTileK, dout + (long)b * S *
                                       ors + (long)h * dtv, ors, q0, S, dtv,
                                       tid);
    };
    if (n > 0) issue(0);
    cp_async_commit();

    float dka[DK / 16][4], dva[DV / 16][4];
#pragma unroll
    for (int i = 0; i < DK / 16; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) dka[i][e] = 0.f;
#pragma unroll
    for (int i = 0; i < DV / 16; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) dva[i][e] = 0.f;
    const int m0k = AccTile<DK>::m0(w), n0k = AccTile<DK>::n0(w);
    const int m0v = AccTile<DV>::m0(w), n0v = AccTile<DV>::n0(w);

    for (int x = 0; x < n; ++x) {
        if (x + 1 < n) issue(x + 1);
        cp_async_commit();
        const int h = kvh * G + x / nqt, q0 = (lo + x % nqt) * BQ;
        float ls[2], dl[2];
        row_stats(lse + (long)b * S * H + h, delta + (long)b * S * H + h, q0,
                  wr, lane, S, H, ls, dl);
        cp_async_wait<1>();
        __syncthreads();
        const uint32_t qs = ring + (x % 2) * kStage, os = qs + L::kTileK;
        float sa[4][4], da[4][4];
        scores<DK, DV>(qs, os, k_s, v_s, wr, wc, lane, sa, da, dtk);
        if (tile_edge(q0, k0, S, causal, window))
            softmax_grad<true>(sa, da, p_s, ds_s, q0, k0, wr, wc, lane, ls,
                               dl, S, causal, window, scale);
        else
            softmax_grad<false>(sa, da, p_s, ds_s, q0, k0, wr, wc, lane, ls,
                                dl, S, causal, window, scale);
        __syncthreads();
        acc_product<DV>(dva, p_s, os, m0v, n0v, lane);
        acc_product<DK>(dka, ds_s, qs, m0k, n0k, lane);
        __syncthreads();
    }
    store_acc<DK>(dk + (long)b * S * krs + (long)kvh * dtk, krs, k0, w, S,
                  dtk, lane, dka);
    store_acc<DV>(dv + (long)b * S * vrs + (long)kvh * dtv, vrs, k0, w, S,
                  dtv, lane, dva);
}

// dQ pass: the forward's block (two consumer warpgroups of 64 query rows,
// a producer warpgroup of TMA copies); Q and dO stay in shared memory, K
// and V tiles of 32 keys stream through a ring of 2 stages (D 256: Q and
// dO 128 KB, the ring 64 KB). S = Q.K^T and dP = dO.V^T are wgmma
// m64n32k16 from shared memory; dS, rounded to bf16 in registers, is the A
// operand of dQ += dS.K, wgmma m64nDk16 with K read MN-major.
constexpr int kDqBK = 32;

template <int DK, int DV> struct DqSmem {
    static constexpr int kQ = kFwdRows * DK * 2;       // a warpgroup's Q
    static constexpr int kO = kFwdRows * DV * 2;       // a warpgroup's dO
    static constexpr int kK = kDqBK * DK * 2;          // one K tile
    static constexpr int kV = kDqBK * DV * 2;          // one V tile
    static constexpr int kBarriers = 2 * kQ + 2 * kO + kStages * (kK + kV);
    static constexpr size_t kAlloc = kBarriers + 8 * (2 * kStages + 1) + 1024;
};

// p = exp(s scale - lse), ds = p (dp - delta) scale on this thread's 64 x
// kDqBK scores (ls = lse log2 e), zero where masked (kMask: the tile
// crosses an edge), rounded to bf16 as the A fragments of dS.K
template <bool kMask>
__device__ __forceinline__ void ds_frags(const float* s, const float* dp,
                                         int k0, int r0, int r1, int t,
                                         int S, int causal, int window,
                                         float scale, const float* ls,
                                         const float* dl,
                                         uint32_t (*da)[4]) {
    const float scale_log2 = scale * kLog2e;
    float ds[kDqBK / 2];
#pragma unroll
    for (int n = 0; n < kDqBK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int i = e / 2, x = 4 * n + e;
            float p = exp2f(fmaf(s[x], scale_log2, -ls[i]));
            if (kMask && !allowed(i ? r1 : r0, k0 + 8 * n + 2 * t + (e & 1),
                                  S, causal, window))
                p = 0.f;
            ds[x] = p * (dp[x] - dl[i]) * scale;
        }
    pack_p<kDqBK>(ds, da);
}

template <int DK, int DV>
__global__ void __launch_bounds__(kFwdThreads, 1)
attn_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_o,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq,
                   int S, int H, int KVH, int causal, int window,
                   float scale, int dtk, int dtv) {
    tile_dts<DK, DV>(&dtk, &dtv);
    using L = DqSmem<DK, DV>;
    constexpr int BK = kDqBK;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* sm = aligned_smem(smem_raw);
    const uint32_t q_s = smem_u32(sm);        // warpgroup u: q_s + u kQ
    const uint32_t o_s = q_s + 2 * L::kQ;     // dO, the same way
    const uint32_t kv_s = o_s + 2 * L::kO;    // stage st: K, then V
    constexpr int kStage = L::kK + L::kV;
    uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBarriers);
    uint64_t* empty = full + kStages;
    uint64_t* q_full = empty + kStages;

    const int tid = threadIdx.x;
    // q tiles from the last (the heaviest under the causal mask)
    const int q0 = (gridDim.x / H - 1 - blockIdx.x / H) * 2 * kFwdRows;
    const int h = blockIdx.x % H, b = blockIdx.y, kvh = h / (H / KVH);
    int lo, hi;
    kv_range(q0, min(q0 + 2 * kFwdRows, S), S, BK, causal, window, &lo, &hi);

    if (tid == 0) {
        for (int s = 0; s < kStages; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], kConsumers);
        }
        mbar_init(q_full, 1);
        mbar_fence_init();
    }
    __syncthreads();

    if (tid >= kConsumers) {
        if constexpr (kMoveRegs<DK>)
            asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                         :: "n"(kProducerRegs));
        if (tid != kConsumers) return;
        using SK = Swz<DK>;
        using SV = Swz<DV>;
        constexpr int kSlabs = DK / SK::kSlabCols;
        constexpr int kQSlab = kFwdRows * SK::kRowBytes;
        constexpr int kKSlab = BK * SK::kRowBytes;
        constexpr int kVSlabs = DV / SV::kSlabCols;
        constexpr int kOSlab = kFwdRows * SV::kRowBytes;
        constexpr int kVSlab = BK * SV::kRowBytes;
        // an MLA pair loads the Q / K slabs that hold a column below dtk:
        // S stops there, and the K slabs past it only reach columns of dQ
        // at or past dtk, which are never stored
        const int qk_slabs = DK == DV ? kSlabs
                                      : (dtk + SK::kSlabCols - 1) /
                                            SK::kSlabCols;
        mbar_expect_tx(q_full, 2 * qk_slabs * kQSlab + 2 * L::kO);
        for (int u = 0; u < 2; ++u) {
            const int row = q0 + u * kFwdRows;
            if constexpr (DK == DV) {
                for (int c = 0; c < kSlabs; ++c) {
                    const int col = c * SK::kSlabCols;
                    tma_load_4d(q_s + u * L::kQ + c * kQSlab, &tm_q, col, h,
                                row, b, q_full);
                    tma_load_4d(o_s + u * L::kO + c * kQSlab, &tm_o, col, h,
                                row, b, q_full);
                }
            } else {
                for (int c = 0; c < qk_slabs; ++c)
                    tma_load_4d(q_s + u * L::kQ + c * kQSlab, &tm_q,
                                c * SK::kSlabCols, h, row, b, q_full);
                for (int c = 0; c < kVSlabs; ++c)
                    tma_load_4d(o_s + u * L::kO + c * kOSlab, &tm_o,
                                c * SV::kSlabCols, h, row, b, q_full);
            }
        }
        for (int j = lo; j < hi; ++j) {
            const int it = j - lo, st = it % kStages;
            if (it >= kStages) mbar_wait(&empty[st], (it / kStages - 1) & 1);
            const uint32_t ks = kv_s + st * kStage;
            mbar_expect_tx(&full[st], qk_slabs * kKSlab + L::kV);
            if constexpr (DK == DV) {
                for (int c = 0; c < kSlabs; ++c) {
                    const int col = c * SK::kSlabCols;
                    tma_load_4d(ks + c * kKSlab, &tm_k, col, kvh, j * BK, b,
                                &full[st]);
                    tma_load_4d(ks + L::kK + c * kKSlab, &tm_v, col, kvh,
                                j * BK, b, &full[st]);
                }
            } else {
                for (int c = 0; c < qk_slabs; ++c)
                    tma_load_4d(ks + c * kKSlab, &tm_k, c * SK::kSlabCols, kvh,
                                j * BK, b, &full[st]);
                for (int c = 0; c < kVSlabs; ++c)
                    tma_load_4d(ks + L::kK + c * kVSlab, &tm_v,
                                c * SV::kSlabCols, kvh, j * BK, b, &full[st]);
            }
        }
        return;
    }

    if constexpr (kMoveRegs<DK>)
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                     :: "n"(kConsumerRegs));
    const int wg = tid / 128, w = (tid % 128) / 32, lane = tid % 32;
    const int t = lane % 4;
    const int qw = q0 + wg * kFwdRows;
    const int r0 = qw + w * 16 + lane / 4, r1 = r0 + 8;
    const uint32_t qa = q_s + wg * L::kQ, oa = o_s + wg * L::kO;
    float ls[2], dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int r = i ? r1 : r0;
        const long at = ((long)b * S + r) * H + h;
        ls[i] = r < S ? lse[at] * kLog2e : 0.f;
        dl[i] = r < S ? delta[at] : 0.f;
    }
    float acc[DK / 2], s[BK / 2], dp[BK / 2];
    uint32_t da[BK / 16][4];
#pragma unroll
    for (int i = 0; i < DK / 2; ++i) acc[i] = 0.f;
    mbar_wait(q_full, 0);

    for (int j = lo; j < hi; ++j) {
        const int it = j - lo, k0 = j * BK;
        const uint32_t ks = kv_s + it % kStages * kStage;
        mbar_wait(&full[it % kStages], (it / kStages) & 1);
        // tiles wholly masked for this warpgroup's rows are skipped
        const bool skip = qw >= S || (causal && k0 > qw + 63) ||
                          (window && qw - (k0 + BK - 1) >= window);
        if (!skip) {
#pragma unroll
            for (int i = 0; i < BK / 2; ++i) s[i] = dp[i] = 0.f;
            fence_regs<BK / 2>(s);
            fence_regs<BK / 2>(dp);
            wgmma_fence();
            issue_scores<DK, BK, DK != DV>(s, qa, ks, dtk);
            issue_scores<DV, BK>(dp, oa, ks + L::kK);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs<BK / 2>(s);
            fence_regs<BK / 2>(dp);
            const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > qw) ||
                              (window && qw + 63 - k0 >= window);
            if (edge)
                ds_frags<true>(s, dp, k0, r0, r1, t, S, causal, window,
                               scale, ls, dl, da);
            else
                ds_frags<false>(s, dp, k0, r0, r1, t, S, causal, window,
                                scale, ls, dl, da);
            fence_regs<DK / 2>(acc);
            wgmma_fence();
            issue_pv<DK, BK>(acc, da, ks);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs<DK / 2>(acc);
        }
        mbar_arrive(&empty[it % kStages]);
    }

    const long qrs = (long)H * dtk;
    bf16* qb = dq + (long)b * S * qrs + (long)h * dtk;
#pragma unroll
    for (int n = 0; n < DK / 8; ++n) {
        const int col = 8 * n + 2 * t;
        if (col >= dtk) continue;
        if (r0 < S)
            *reinterpret_cast<uint32_t*>(qb + (long)r0 * qrs + col) =
                pack_bf16(acc[4 * n], acc[4 * n + 1]);
        if (r1 < S)
            *reinterpret_cast<uint32_t*>(qb + (long)r1 * qrs + col) =
                pack_bf16(acc[4 * n + 2], acc[4 * n + 3]);
    }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename K>
int set_smem(K kernel, size_t bytes) {
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// delta = sum over Dv of dout * out
template <typename T>
int delta(const void* out, const void* dout, float* dl, long rows, int Dv,
          cudaStream_t st) {
    simt::attn_delta_kernel<T>
        <<<(unsigned)((rows * 32 + simt::kThreads - 1) / simt::kThreads),
           simt::kThreads, 0, st>>>((const T*)out, (const T*)dout, dl, rows,
                                    Dv);
    return (int)cudaGetLastError();
}

template <int DK, int DV>
int fwd_f32(const void* q, const void* k, const void* v, void* out,
            float* lse, int B, int S, int H, int KVH, int causal, int window,
            float scale, int dtk, int dtv, cudaStream_t st) {
    constexpr int BQ = 64, BK = 64;
    const size_t bytes = sizeof(float) * ((BQ + BK) * (DK + 1) + BK * DV +
                                          BQ * (BK + 1) + 3 * BQ);
    auto kern = simt::attn_fwd_kernel<float, DK, DV>;
    if (int rc = set_smem(kern, bytes)) return rc;
    const dim3 grid((S + BQ - 1) / BQ, H, B);
    kern<<<grid, simt::kThreads, bytes, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)out, lse,
        S, H, KVH, causal, window, scale, dtk, dtv);
    return (int)cudaGetLastError();
}

template <int DK, int DV>
int bwd_f32(const void* q, const void* k, const void* v, const void* out,
            const void* dout, const float* lse, float* dl, void* dq, void* dk,
            void* dv, int B, int S, int H, int KVH, int causal, int window,
            float scale, int dtk, int dtv, cudaStream_t st) {
    constexpr int BQ = 32, BK = 32;
    if (int rc = delta<float>(out, dout, dl, (long)B * S * H, dtv, st))
        return rc;
    const size_t b_kv = sizeof(float) * (2 * 32 * (DK + 1) + 2 * 32 * (DV + 1) +
                                         2 * BQ * (BK + 1) + 2 * BQ);
    auto kkv = simt::attn_bwd_dkdv_kernel<float, DK, DV>;
    if (int rc = set_smem(kkv, b_kv)) return rc;
    kkv<<<dim3((S + BK - 1) / BK, KVH, B), simt::kThreads, b_kv, st>>>(
        (const float*)q, (const float*)k, (const float*)v,
        (const float*)dout, lse, dl, (float*)dk, (float*)dv, S, H, KVH,
        causal, window, scale, dtk, dtv);
    if (int rc = (int)cudaGetLastError()) return rc;
    const size_t b_q = sizeof(float) * (2 * 32 * (DK + 1) + 2 * 32 * (DV + 1) +
                                        BQ * (BK + 1) + 2 * BQ);
    auto kq = simt::attn_bwd_dq_kernel<float, DK, DV>;
    if (int rc = set_smem(kq, b_q)) return rc;
    kq<<<dim3((S + BQ - 1) / BQ, H, B), simt::kThreads, b_q, st>>>(
        (const float*)q, (const float*)k, (const float*)v,
        (const float*)dout, lse, dl, (float*)dq, S, H, KVH, causal, window,
        scale, dtk, dtv);
    return (int)cudaGetLastError();
}

// a TMA map of one (B, S, heads, dt) bf16 tensor whose box is one slab of
// kRows rows of one head of a tile D columns wide, swizzled as sm90.cuh
// lays tiles out. The map spans the true dt columns, so the box's columns
// at or past dt (a head dim run on the next tile width up) come back zero,
// as its rows past S do.
template <int D, int kRows>
int row_map(CUtensorMap* map, const void* base, int B, int S, int heads,
            int dt) {
    int rc = 0;
    const sm90::EncodeTiled encode = sm90::tensor_map_encoder(&rc);
    if (encode == nullptr) return rc;
    using Sw = sm90::Swz<D>;
    const cuuint64_t dims[4] = {(cuuint64_t)dt, (cuuint64_t)heads,
                                (cuuint64_t)S, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)dt * 2,
                                   (cuuint64_t)heads * dt * 2,
                                   (cuuint64_t)S * heads * dt * 2};
    const cuuint32_t box[4] = {(cuuint32_t)Sw::kSlabCols, 1,
                               (cuuint32_t)kRows, 1};
    const cuuint32_t step[4] = {1, 1, 1, 1};
    const CUtensorMapSwizzle swizzle =
        Sw::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
        : Sw::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                              : CU_TENSOR_MAP_SWIZZLE_32B;
    const CUresult res = encode(
        map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
        dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// setmaxnreg moves registers within the block's allocation: a build of a
// producer / consumer kernel with fewer than kFwdRegs would leave its
// consumers waiting, so it is refused (N: the accumulator's width)
template <int N, typename K>
int regs_moved(K kernel) {
    if (!tc::kMoveRegs<N>) return 0;
    cudaFuncAttributes attr;
    if (int rc = (int)cudaFuncGetAttributes(&attr, kernel)) return rc;
    return attr.numRegs == tc::kFwdRegs ? 0
                                        : (int)cudaErrorLaunchOutOfResources;
}

template <int DK, int DV>
int fwd_bf16(const void* q, const void* k, const void* v, void* out,
             float* lse, int B, int S, int H, int KVH, int causal,
             int window, float scale, int dtk, int dtv, cudaStream_t st) {
    using bf16 = __nv_bfloat16;
    const size_t bytes = tc::FwdSmem<DK, DV>::kAlloc;
    auto kern = tc::attn_fwd_kernel<DK, DV>;
    if (int rc = set_smem(kern, bytes)) return rc;
    if (int rc = regs_moved<DV>(kern)) return rc;
    CUtensorMap tq, tk, tv;
    if (int rc = row_map<DK, tc::kFwdRows>(&tq, q, B, S, H, dtk)) return rc;
    if (int rc = row_map<DK, tc::kFwdBK>(&tk, k, B, S, KVH, dtk)) return rc;
    if (int rc = row_map<DV, tc::kFwdBK>(&tv, v, B, S, KVH, dtv)) return rc;
    const dim3 grid((S + 2 * tc::kFwdRows - 1) / (2 * tc::kFwdRows) * H, B);
    kern<<<grid, tc::kFwdThreads, bytes, st>>>(
        tq, tk, tv, (bf16*)out, lse, S, H, KVH, causal, window,
        scale * tc::kLog2e, dtk, dtv);
    return (int)cudaGetLastError();
}

template <int DK, int DV>
int bwd_bf16(const void* q, const void* k, const void* v, const void* out,
             const void* dout, const float* lse, float* dl, void* dq,
             void* dk, void* dv, int B, int S, int H, int KVH, int causal,
             int window, float scale, int dtk, int dtv, cudaStream_t st) {
    using bf16 = __nv_bfloat16;
    constexpr int BT = tc::kBwdB;
    if (int rc = delta<bf16>(out, dout, dl, (long)B * S * H, dtv, st))
        return rc;
    const size_t bytes = tc::BwdSmem<DK, DV>::kAlloc;
    auto kkv = tc::attn_bwd_dkdv_kernel<DK, DV>;
    if (int rc = set_smem(kkv, bytes)) return rc;
    kkv<<<dim3((S + BT - 1) / BT * KVH, B), tc::kBwdThreads, bytes, st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
        lse, dl, (bf16*)dk, (bf16*)dv, S, H, KVH, causal, window, scale, dtk,
        dtv);
    if (int rc = (int)cudaGetLastError()) return rc;
    auto kq = tc::attn_bwd_dq_kernel<DK, DV>;
    const size_t q_bytes = tc::DqSmem<DK, DV>::kAlloc;
    if (int rc = set_smem(kq, q_bytes)) return rc;
    if (int rc = regs_moved<DK>(kq)) return rc;
    CUtensorMap tq, to, tk, tv;
    if (int rc = row_map<DK, tc::kFwdRows>(&tq, q, B, S, H, dtk)) return rc;
    if (int rc = row_map<DV, tc::kFwdRows>(&to, dout, B, S, H, dtv))
        return rc;
    if (int rc = row_map<DK, tc::kDqBK>(&tk, k, B, S, KVH, dtk)) return rc;
    if (int rc = row_map<DV, tc::kDqBK>(&tv, v, B, S, KVH, dtv)) return rc;
    kq<<<dim3((S + 2 * tc::kFwdRows - 1) / (2 * tc::kFwdRows) * H, B),
         tc::kFwdThreads, q_bytes, st>>>(tq, to, tk, tv, lse, dl, (bf16*)dq,
                                         S, H, KVH, causal, window, scale,
                                         dtk, dtv);
    return (int)cudaGetLastError();
}

// (D, Dv) picks the tile widths. Equal pairs: 16, 32, 64, 128 and 256 are
// their own; 24 runs on the 32-column tiles and 96 on the 128-column ones
// (the launchers take the true D as dt: the loads zero the columns at dt
// and past it, the stores skip them, and zero columns leave every product
// as it is). MLA's pairs: D 192 / Dv 128 on the 256- and 128-column tiles,
// D 24 / Dv 16 on the 32- and 16-column ones. Any other pair is refused.
#define REPRO_BY_HEAD_DIMS(FN, ...)                              \
    if (D == Dv) {                                               \
        switch (D) {                                             \
            case 16: return FN<16, 16>(__VA_ARGS__);             \
            case 24: return FN<32, 32>(__VA_ARGS__);             \
            case 32: return FN<32, 32>(__VA_ARGS__);             \
            case 64: return FN<64, 64>(__VA_ARGS__);             \
            case 96: return FN<128, 128>(__VA_ARGS__);           \
            case 128: return FN<128, 128>(__VA_ARGS__);          \
            case 256: return FN<256, 256>(__VA_ARGS__);          \
            default: return (int)cudaErrorInvalidValue;          \
        }                                                        \
    }                                                            \
    if (D == 192 && Dv == 128) return FN<256, 128>(__VA_ARGS__); \
    if (D == 24 && Dv == 16) return FN<32, 16>(__VA_ARGS__);     \
    return (int)cudaErrorInvalidValue;

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).
// (D, Dv): D == Dv in {16, 24, 32, 64, 96, 128, 256}, or (192, 128), or
// (24, 16).
extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v,
                               void* out, float* lse, int B, int S, int H,
                               int KVH, int D, int Dv, int causal,
                               int window, float scale, int dtype,
                               void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 0) {
        REPRO_BY_HEAD_DIMS(fwd_f32, q, k, v, out, lse, B, S, H, KVH, causal,
                           window, scale, D, Dv, st)
    }
    REPRO_BY_HEAD_DIMS(fwd_bf16, q, k, v, out, lse, B, S, H, KVH, causal,
                       window, scale, D, Dv, st)
}

// delta is a (B, S, H) f32 scratch buffer the caller allocates.
extern "C" int repro_flash_bwd(const void* q, const void* k, const void* v,
                               const void* out, const void* dout,
                               const float* lse, float* delta, void* dq,
                               void* dk, void* dv, int B, int S, int H,
                               int KVH, int D, int Dv, int causal,
                               int window, float scale, int dtype,
                               void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 0) {
        REPRO_BY_HEAD_DIMS(bwd_f32, q, k, v, out, dout, lse, delta, dq, dk,
                           dv, B, S, H, KVH, causal, window, scale, D, Dv, st)
    }
    REPRO_BY_HEAD_DIMS(bwd_bf16, q, k, v, out, dout, lse, delta, dq, dk, dv,
                       B, S, H, KVH, causal, window, scale, D, Dv, st)
}
