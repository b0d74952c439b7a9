// Fused cross-entropy forward and backward for Hopper (sm_90a), f32 or bf16
// storage, f32 logits and accumulators.
//
// Replaces:
//   repro_ce_fwd  <- src/repro/kernels/fused_ce.py fused_cross_entropy
//                    (_ce_kernel): per token logsumexp_v(h.W) - (h.W)[y],
//                    vocab tiled, plus the argmax lm_loss reports
//   repro_ce_bwd  <- the gradient of lm_loss's chunked loss
//                    (src/repro/models/transformer.py:302, chunk_fn), which
//                    the reference leaves to XLA: the TPU kernel is
//                    forward-only
//
// Layout: h (T, d); e (V, d), the transpose of W (d, V), which is how the
// tied embedding lies in memory; y (T,) int64; lse, g (T,) f32.
//
// Bound on the card. At gemma3-4b's full width (T 4096, d 2560, V 262144)
// the forward is one T x V x d product, 5.50e12 flop, and the backward at
// least three (logits again, dh, dW): operations, not bytes, bound it
// (about 5.6 ms and 16.7 ms at the H100's 989 TFLOP/s in bf16). bf16 rows
// take the tensor cores (wmma 16x16x16, f32 accumulation, staged through
// shared memory without a copy pipeline), and so need d a multiple of 16
// and 32-byte-aligned bases: the launchers refuse anything else. f32 rows,
// and a ragged last tile of the backward's second product, take f32 FMA on
// the CUDA cores. Neither is near the bound: no TMA, no wgmma,
// no warp specialisation. What the design keeps is the memory side: the
// T x V logits never reach device memory.
//
// Forward: block (64 tokens, one vocab split); a 64 x 64 logits tile at a
// time, each thread 4 x 4 of it; online max, sum, target logit and argmax
// per token, reduced over the 16 lanes that share a row; a second launch
// merges the splits in vocab order (ties keep the first index).
// Backward: one kernel, two launches. A block owns 16 rows (tokens for dh,
// vocab rows for dW) and a 16 x d f32 accumulator in shared memory, and
// walks the other side in tiles of 128: logits tile (again), dlogits =
// (exp(logit - lse) - onehot) * g, then acc += dlogits . rows. No atomics:
// every output row has one owner. The launchers allocate nothing, do not
// synchronise, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;
constexpr int kKC = 32;                // depth of one staged chunk of d

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
    return __float2bfloat16(x);
}
// two adjacent elements (even index, so the pair is aligned)
__device__ __forceinline__ float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// acc[i][j] = X[tr*TR + i] . Y[tc*TC + j] over d, for the BR rows of X and
// BO rows of Y (row stride d; rows past x_n / y_n read as zero), staged
// through shared memory kKC columns at a time, depth-major so that a thread
// reads its TR and TC operands as neighbours.
template <typename T, int BR, int BO, int TR, int TC>
__device__ __forceinline__ void nt_tile(const T* __restrict__ X, int x_n,
                                        const T* __restrict__ Y, int y_n,
                                        int d, float* a_s, float* b_s,
                                        float (&acc)[TR][TC]) {
    constexpr int AS = BR + 4, BS = BO + 4, NTC = BO / TC;
    static_assert((BR / TR) * NTC == kThreads, "one output block per thread");
    const int tid = threadIdx.x, tr = tid / NTC, tc = tid % NTC;
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < d; k0 += kKC) {
        __syncthreads();
        for (int i = tid; i < BR * kKC; i += kThreads) {
            const int r = i / kKC, kk = i % kKC;
            a_s[kk * AS + r] = (r < x_n && k0 + kk < d)
                                   ? to_f(X[(long)r * d + k0 + kk])
                                   : 0.f;
        }
        for (int i = tid; i < BO * kKC; i += kThreads) {
            const int r = i / kKC, kk = i % kKC;
            b_s[kk * BS + r] = (r < y_n && k0 + kk < d)
                                   ? to_f(Y[(long)r * d + k0 + kk])
                                   : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < kKC; ++kk) {
            float a[TR], b[TC];
#pragma unroll
            for (int i = 0; i < TR; ++i) a[i] = a_s[kk * AS + tr * TR + i];
#pragma unroll
            for (int j = 0; j < TC; ++j) b[j] = b_s[kk * BS + tc * TC + j];
#pragma unroll
            for (int i = 0; i < TR; ++i)
#pragma unroll
                for (int j = 0; j < TC; ++j)
                    acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
    }
}

// The same products on the tensor cores, for bf16 rows whose width d is a
// multiple of 16 and whose base is 32-byte aligned (the host checks): wmma
// 16x16x16 tiles with f32 accumulation. The staged chunks stay bf16, with a
// row stride of kKC + 8 elements (80 bytes, a multiple of the 16 bytes a
// fragment row load needs, off the bank period).
constexpr int kTcLd = kKC + 8;
using Bf16 = __nv_bfloat16;

// rows [0, n) of src (row stride d) at depth [k0, k0 + kKC) -> dst, in
// 16-byte pieces; rows past n_valid and depths past d read as zero
__device__ __forceinline__ void stage_bf16(Bf16* dst, const Bf16* src, int n,
                                           int n_valid, int d, int k0) {
    constexpr int kPieces = kKC / 8;
    for (int i = threadIdx.x; i < n * kPieces; i += kThreads) {
        const int r = i / kPieces, k = k0 + (i % kPieces) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (r < n_valid && k < d)
            v = *reinterpret_cast<const uint4*>(src + (long)r * d + k);
        *reinterpret_cast<uint4*>(dst + r * kTcLd + (i % kPieces) * 8) = v;
    }
}

// nt_tile on the tensor cores: the BR x BO result goes through the f32
// tile c_s (row stride BO + 4) and comes back in nt_tile's per-thread
// layout, so the code after it does not change
template <int BR, int BO, int TR, int TC>
__device__ __forceinline__ void nt_tile_tc(const Bf16* __restrict__ X,
                                           int x_n, const Bf16* __restrict__ Y,
                                           int y_n, int d, Bf16* a_s,
                                           Bf16* b_s, float* c_s,
                                           float (&acc)[TR][TC]) {
    using namespace nvcuda;
    constexpr int kWarps = kThreads / 32, NFC = BO / 16;
    constexpr int FPW = (BR / 16) * NFC / kWarps, CS = BO + 4;
    static_assert((BR / 16) * NFC % kWarps == 0, "whole fragments per warp");
    const int warp = threadIdx.x / 32;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> cf[FPW];
#pragma unroll
    for (int i = 0; i < FPW; ++i) wmma::fill_fragment(cf[i], 0.f);
    for (int k0 = 0; k0 < d; k0 += kKC) {
        __syncthreads();
        stage_bf16(a_s, X, BR, x_n, d, k0);
        stage_bf16(b_s, Y, BO, y_n, d, k0);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kKC; kk += 16) {
#pragma unroll
            for (int i = 0; i < FPW; ++i) {
                const int f = warp * FPW + i;
                wmma::fragment<wmma::matrix_a, 16, 16, 16, Bf16,
                               wmma::row_major> a;
                wmma::fragment<wmma::matrix_b, 16, 16, 16, Bf16,
                               wmma::col_major> b;
                wmma::load_matrix_sync(a, a_s + (f / NFC) * 16 * kTcLd + kk,
                                       kTcLd);
                wmma::load_matrix_sync(b, b_s + (f % NFC) * 16 * kTcLd + kk,
                                       kTcLd);
                wmma::mma_sync(cf[i], a, b, cf[i]);
            }
        }
    }
#pragma unroll
    for (int i = 0; i < FPW; ++i) {
        const int f = warp * FPW + i;
        wmma::store_matrix_sync(c_s + (f / NFC) * 16 * CS + (f % NFC) * 16,
                                cf[i], CS, wmma::mem_row_major);
    }
    __syncthreads();
    const int tr = threadIdx.x / (BO / TC), tc = threadIdx.x % (BO / TC);
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j)
            acc[i][j] = c_s[(tr * TR + i) * CS + tc * TC + j];
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

constexpr int kFwdT = 64, kFwdV = 64, kFwdTR = 4, kFwdTC = 4;

// partials per (split, token): part_f[.][0..3] = max, sum of exp(x - max),
// target logit (0 when the target is in another split), best logit;
// part_i = index of the best logit
template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_fwd_kernel(const T* __restrict__ h, const T* __restrict__ e,
              const long long* __restrict__ y, float* __restrict__ part_f,
              int* __restrict__ part_i, int n_tok, int V, int d,
              int v_per_split) {
    __shared__ __align__(32) float a_s[kKC * (kFwdT + 4)];
    __shared__ __align__(32) float b_s[kKC * (kFwdV + 4)];
    const int t0 = blockIdx.x * kFwdT, split = blockIdx.y;
    const int v_begin = split * v_per_split;
    const int v_end = min(V, v_begin + v_per_split);
    const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;

    float m[kFwdTR], l[kFwdTR], tgt[kFwdTR], best[kFwdTR];
    int arg[kFwdTR];
    long long yt[kFwdTR];
#pragma unroll
    for (int i = 0; i < kFwdTR; ++i) {
        const int row = t0 + tr * kFwdTR + i;
        m[i] = kNegInf;
        l[i] = 0.f;
        tgt[i] = 0.f;
        best[i] = -INFINITY;
        arg[i] = v_begin;
        yt[i] = row < n_tok ? y[row] : -1;
    }
    for (int v0 = v_begin; v0 < v_end; v0 += kFwdV) {
        float acc[kFwdTR][kFwdTC];
        if constexpr (std::is_same<T, Bf16>::value) {
            // the f32 staging tiles hold the bf16 chunks (10,240 of 17,408
            // bytes) and c_s is its own 17,408 bytes
            __shared__ __align__(32) float c_s[kFwdT * (kFwdV + 4)];
            nt_tile_tc<kFwdT, kFwdV, kFwdTR, kFwdTC>(
                h + (long)t0 * d, n_tok - t0, e + (long)v0 * d, v_end - v0,
                d, reinterpret_cast<Bf16*>(a_s), reinterpret_cast<Bf16*>(b_s),
                c_s, acc);
        } else {
            nt_tile<T, kFwdT, kFwdV, kFwdTR, kFwdTC>(
                h + (long)t0 * d, n_tok - t0, e + (long)v0 * d, v_end - v0,
                d, a_s, b_s, acc);
        }
#pragma unroll
        for (int i = 0; i < kFwdTR; ++i) {
            float tmax = kNegInf, tbest = -INFINITY, hit = 0.f;
            int targ = 0x7fffffff;
#pragma unroll
            for (int j = 0; j < kFwdTC; ++j) {
                const int col = v0 + tc * kFwdTC + j;
                if (col < v_end) {
                    const float x = acc[i][j];
                    tmax = fmaxf(tmax, x);
                    if (x > tbest) {
                        tbest = x;
                        targ = col;
                    }
                    if (col == yt[i]) hit += x;
                }
            }
            // the 16 lanes tc = 0..15 of this row are one half-warp
            for (int off = 8; off; off >>= 1) {
                tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
                const float ob = __shfl_xor_sync(0xffffffffu, tbest, off);
                const int oa = __shfl_xor_sync(0xffffffffu, targ, off);
                if (ob > tbest || (ob == tbest && oa < targ)) {
                    tbest = ob;
                    targ = oa;
                }
                hit += __shfl_xor_sync(0xffffffffu, hit, off);
            }
            const float m_new = fmaxf(m[i], tmax);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < kFwdTC; ++j)
                if (v0 + tc * kFwdTC + j < v_end)
                    sum += expf(acc[i][j] - m_new);
            for (int off = 8; off; off >>= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, off);
            l[i] = l[i] * expf(m[i] - m_new) + sum;
            m[i] = m_new;
            tgt[i] += hit;
            if (tbest > best[i]) {      // earlier tiles win ties
                best[i] = tbest;
                arg[i] = targ;
            }
        }
    }
    if (tc == 0) {
#pragma unroll
        for (int i = 0; i < kFwdTR; ++i) {
            const int row = t0 + tr * kFwdTR + i;
            if (row < n_tok) {
                const long o = (long)split * n_tok + row;
                part_f[o * 4 + 0] = m[i];
                part_f[o * 4 + 1] = l[i];
                part_f[o * 4 + 2] = tgt[i];
                part_f[o * 4 + 3] = best[i];
                part_i[o] = arg[i];
            }
        }
    }
}

__global__ void __launch_bounds__(kThreads)
ce_merge_kernel(const float* __restrict__ part_f,
                const int* __restrict__ part_i, float* __restrict__ loss,
                float* __restrict__ lse, long long* __restrict__ pred,
                int n_tok, int n_split) {
    const int t = blockIdx.x * kThreads + threadIdx.x;
    if (t >= n_tok) return;
    float mx = kNegInf;
    for (int s = 0; s < n_split; ++s)
        mx = fmaxf(mx, part_f[((long)s * n_tok + t) * 4]);
    float sum = 0.f, tg = 0.f, best = -INFINITY;
    int arg = 0;
    for (int s = 0; s < n_split; ++s) {
        const float* p = part_f + ((long)s * n_tok + t) * 4;
        sum += p[1] * expf(p[0] - mx);
        tg += p[2];
        if (p[3] > best) {              // splits in vocab order: first wins
            best = p[3];
            arg = part_i[(long)s * n_tok + t];
        }
    }
    const float z = mx + logf(fmaxf(sum, 1e-30f));
    lse[t] = z;
    loss[t] = z - tg;
    pred[t] = arg;
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

constexpr int kBwdR = 16, kBwdO = 128, kBwdTR = 2, kBwdTC = 4;
constexpr int kGLd = kBwdO + 8;        // bf16 row stride of the hi / lo tiles

// acc_s[r][c] += sum_o G[r][o] Y[o][c] over a whole tile of kBwdO rows of Y
// (row stride d, a multiple of 16) on the tensor cores. G is split into
// bf16 hi + lo, which carries it to within 2^-16 of its f32 value (the
// outputs are rounded to bf16, 2^-9), and both halves go through wmma with
// f32 accumulation. The tensor cores' f32 accumulation truncates, so the
// tile's sum starts from zero and joins acc_s through one rounded add:
// chained through acc_s, dh's 2,048 vocab tiles at V 262144 biased it by
// about 1e-3 of its size. Each warp owns 16-column strips of acc_s.
__device__ __forceinline__ void nn_tile_tc(float* acc_s, const Bf16* gh_s,
                                           const Bf16* gl_s,
                                           const Bf16* __restrict__ Y,
                                           int d) {
    using namespace nvcuda;
    constexpr int kWarps = kThreads / 32;
    for (int c0 = (threadIdx.x / 32) * 16; c0 < d; c0 += kWarps * 16) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> cf, ca;
        wmma::fill_fragment(cf, 0.f);
#pragma unroll
        for (int ko = 0; ko < kBwdO; ko += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, Bf16, wmma::row_major>
                ah, al;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, Bf16, wmma::row_major>
                b;
            wmma::load_matrix_sync(ah, gh_s + ko, kGLd);
            wmma::load_matrix_sync(al, gl_s + ko, kGLd);
            wmma::load_matrix_sync(b, Y + (long)ko * d + c0, d);
            wmma::mma_sync(cf, ah, b, cf);
            wmma::mma_sync(cf, al, b, cf);
        }
        // fragments of one type share one element layout
        wmma::load_matrix_sync(ca, acc_s + c0, d, wmma::mem_row_major);
#pragma unroll
        for (int i = 0; i < ca.num_elements; ++i) ca.x[i] += cf.x[i];
        wmma::store_matrix_sync(acc_s + c0, ca, d, wmma::mem_row_major);
    }
}

// kOwnTokens: the block's 16 rows are tokens and it writes dh; otherwise
// they are vocab rows and it writes dW^T (V, d). bf16: the logits tiles on
// the tensor cores, and so the dlogits products of whole tiles; a ragged
// last tile takes the CUDA-core product, which reads no row past the end.
template <typename T, bool kOwnTokens>
__global__ void __launch_bounds__(kThreads)
ce_bwd_kernel(const T* __restrict__ h, const T* __restrict__ e,
              const long long* __restrict__ y, const float* __restrict__ lse,
              const float* __restrict__ g, T* __restrict__ out, int n_tok,
              int V, int d) {
    extern __shared__ __align__(32) float smem[];
    float* acc_s = smem;                               // [kBwdR][d]
    float* a_s = acc_s + kBwdR * d;                    // [kKC][kBwdR + 4]
    float* b_s = a_s + kKC * (kBwdR + 4);              // [kKC][kBwdO + 4]
    float* g_s = b_s + kKC * (kBwdO + 4);              // [kBwdO][kBwdR]
    float* c_s = g_s + kBwdO * kBwdR;                  // [kBwdR][kBwdO + 4]
    Bf16* gh_s = reinterpret_cast<Bf16*>(c_s + kBwdR * (kBwdO + 4));
    Bf16* gl_s = gh_s + kBwdR * kGLd;                  // both [kBwdR][kGLd]

    const T* own = kOwnTokens ? h : e;
    const T* oth = kOwnTokens ? e : h;
    const int n_own = kOwnTokens ? n_tok : V;
    const int n_oth = kOwnTokens ? V : n_tok;
    const int tid = threadIdx.x, r0 = blockIdx.x * kBwdR;
    const int tr = tid / (kBwdO / kBwdTC), tc = tid % (kBwdO / kBwdTC);
    for (int i = tid; i < kBwdR * d; i += kThreads) acc_s[i] = 0.f;

    for (int o0 = 0; o0 < n_oth; o0 += kBwdO) {
        const int n_o = min(kBwdO, n_oth - o0);
        float acc[kBwdTR][kBwdTC];
        bool tc_tile = false;
        if constexpr (std::is_same<T, Bf16>::value) {
            tc_tile = n_o == kBwdO;
            // the f32 staging tiles hold the bf16 chunks
            nt_tile_tc<kBwdR, kBwdO, kBwdTR, kBwdTC>(
                own + (long)r0 * d, n_own - r0, oth + (long)o0 * d, n_o, d,
                reinterpret_cast<Bf16*>(a_s), reinterpret_cast<Bf16*>(b_s),
                c_s, acc);
        } else {
            nt_tile<T, kBwdR, kBwdO, kBwdTR, kBwdTC>(
                own + (long)r0 * d, n_own - r0, oth + (long)o0 * d, n_o, d,
                a_s, b_s, acc);
        }
        // dlogits of this tile: other-major g_s[o][r] for the CUDA cores,
        // row-major bf16 hi / lo for the tensor cores
#pragma unroll
        for (int i = 0; i < kBwdTR; ++i)
#pragma unroll
            for (int j = 0; j < kBwdTC; ++j) {
                const int r = tr * kBwdTR + i, o = tc * kBwdTC + j;
                float gv = 0.f;
                if (r0 + r < n_own && o < n_o) {
                    const int tok = kOwnTokens ? r0 + r : o0 + o;
                    const int voc = kOwnTokens ? o0 + o : r0 + r;
                    float p = expf(acc[i][j] - lse[tok]);
                    if (voc == y[tok]) p -= 1.f;
                    gv = p * g[tok];
                }
                if (tc_tile) {
                    const Bf16 hi = __float2bfloat16(gv);
                    gh_s[r * kGLd + o] = hi;
                    gl_s[r * kGLd + o] =
                        __float2bfloat16(gv - __bfloat162float(hi));
                } else {
                    g_s[o * kBwdR + r] = gv;
                }
            }
        __syncthreads();
        const T* yb = oth + (long)o0 * d;
        if constexpr (std::is_same<T, Bf16>::value) {
            if (tc_tile) {
                nn_tile_tc(acc_s, gh_s, gl_s, yb, d);
                continue;    // the next nt_tile syncs before smem is reused
            }
        }
        // acc_s[r][c] += sum_o g_s[o][r] * oth[o0 + o][c]; each thread owns
        // the column pairs c = 2 tid + 512 m
        for (int c = 2 * tid; c < d; c += 2 * kThreads) {
            float p0[kBwdR], p1[kBwdR];
#pragma unroll
            for (int r = 0; r < kBwdR; ++r) p0[r] = p1[r] = 0.f;
#pragma unroll 4
            for (int o = 0; o < n_o; ++o) {
                const float2 yv = load2(yb + (long)o * d + c);
                const float4* gq = reinterpret_cast<const float4*>(
                    g_s + o * kBwdR);
#pragma unroll
                for (int q = 0; q < kBwdR / 4; ++q) {
                    const float4 gg = gq[q];
                    p0[4 * q + 0] = fmaf(gg.x, yv.x, p0[4 * q + 0]);
                    p0[4 * q + 1] = fmaf(gg.y, yv.x, p0[4 * q + 1]);
                    p0[4 * q + 2] = fmaf(gg.z, yv.x, p0[4 * q + 2]);
                    p0[4 * q + 3] = fmaf(gg.w, yv.x, p0[4 * q + 3]);
                    p1[4 * q + 0] = fmaf(gg.x, yv.y, p1[4 * q + 0]);
                    p1[4 * q + 1] = fmaf(gg.y, yv.y, p1[4 * q + 1]);
                    p1[4 * q + 2] = fmaf(gg.z, yv.y, p1[4 * q + 2]);
                    p1[4 * q + 3] = fmaf(gg.w, yv.y, p1[4 * q + 3]);
                }
            }
#pragma unroll
            for (int r = 0; r < kBwdR; ++r) {
                acc_s[r * d + c] += p0[r];
                acc_s[r * d + c + 1] += p1[r];
            }
        }
        // the next nt_tile starts with __syncthreads before g_s is rewritten
    }
    __syncthreads();
    for (int i = tid; i < kBwdR * d; i += kThreads) {
        const int r = i / d;
        if (r0 + r < n_own)
            out[(long)r0 * d + i] = from_f<T>(acc_s[i]);
    }
}

size_t bwd_smem(int d) {
    return sizeof(float) * ((size_t)kBwdR * d + kKC * (kBwdR + 4) +
                            kKC * (kBwdO + 4) + kBwdO * kBwdR +
                            kBwdR * (kBwdO + 4)) +
           sizeof(Bf16) * 2 * kBwdR * kGLd;
}

// what the tensor cores need of bf16 rows: d a multiple of 16 and
// 32-byte-aligned bases (the wrapper checks first; this refuses what a
// caller of the C function gets wrong)
template <typename T>
bool rows_ok(const void* h, const void* e, int d) {
    const auto aligned = [](const void* p) {
        return (reinterpret_cast<std::uintptr_t>(p) & 31u) == 0;
    };
    return !std::is_same<T, Bf16>::value ||
           (d % 16 == 0 && aligned(h) && aligned(e));
}

template <typename T>
int fwd(const void* h, const void* e, const long long* y, float* part_f,
        int* part_i, float* loss, float* lse, long long* pred, int n_tok,
        int V, int d, int v_per_split, cudaStream_t st) {
    if (!rows_ok<T>(h, e, d)) return (int)cudaErrorInvalidValue;
    const int n_split = (V + v_per_split - 1) / v_per_split;
    ce_fwd_kernel<T><<<dim3((n_tok + kFwdT - 1) / kFwdT, n_split), kThreads,
                       0, st>>>((const T*)h, (const T*)e, y, part_f, part_i,
                                n_tok, V, d, v_per_split);
    if (int rc = (int)cudaGetLastError()) return rc;
    ce_merge_kernel<<<(n_tok + kThreads - 1) / kThreads, kThreads, 0, st>>>(
        part_f, part_i, loss, lse, pred, n_tok, n_split);
    return (int)cudaGetLastError();
}

template <typename T>
int bwd(const void* h, const void* e, const long long* y, const float* lse,
        const float* g, void* dh, void* de, int n_tok, int V, int d,
        cudaStream_t st) {
    if (!rows_ok<T>(h, e, d)) return (int)cudaErrorInvalidValue;
    const size_t bytes = bwd_smem(d);
    auto k_dh = ce_bwd_kernel<T, true>;
    auto k_de = ce_bwd_kernel<T, false>;
    if (int rc = (int)cudaFuncSetAttribute(
            k_dh, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes))
        return rc;
    if (int rc = (int)cudaFuncSetAttribute(
            k_de, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes))
        return rc;
    k_dh<<<(n_tok + kBwdR - 1) / kBwdR, kThreads, bytes, st>>>(
        (const T*)h, (const T*)e, y, lse, g, (T*)dh, n_tok, V, d);
    if (int rc = (int)cudaGetLastError()) return rc;
    k_de<<<(V + kBwdR - 1) / kBwdR, kThreads, bytes, st>>>(
        (const T*)h, (const T*)e, y, lse, g, (T*)de, n_tok, V, d);
    return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. part_f (n_split, T, 4) f32 and part_i
// (n_split, T) int32 are scratch the caller allocates, n_split =
// ceil(V / v_per_split); v_per_split is a multiple of 64. bf16 rows need d
// a multiple of 16 and 32-byte-aligned h and e, else cudaErrorInvalidValue.
extern "C" int repro_ce_fwd(const void* h, const void* e, const void* y,
                            void* part_f, void* part_i, void* loss, void* lse,
                            void* pred, int n_tok, int V, int d,
                            int v_per_split, int dtype, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const long long* yy = (const long long*)y;
    if (dtype == 0)
        return fwd<float>(h, e, yy, (float*)part_f, (int*)part_i,
                          (float*)loss, (float*)lse, (long long*)pred, n_tok,
                          V, d, v_per_split, st);
    return fwd<__nv_bfloat16>(h, e, yy, (float*)part_f, (int*)part_i,
                              (float*)loss, (float*)lse, (long long*)pred,
                              n_tok, V, d, v_per_split, st);
}

// d must be even (bf16: as for repro_ce_fwd); dh (T, d) and de (V, d) in
// the inputs' dtype.
extern "C" int repro_ce_bwd(const void* h, const void* e, const void* y,
                            const void* lse, const void* g, void* dh,
                            void* de, int n_tok, int V, int d, int dtype,
                            void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const long long* yy = (const long long*)y;
    if (dtype == 0)
        return bwd<float>(h, e, yy, (const float*)lse, (const float*)g, dh,
                          de, n_tok, V, d, st);
    return bwd<__nv_bfloat16>(h, e, yy, (const float*)lse, (const float*)g,
                              dh, de, n_tok, V, d, st);
}
