// Fused cross-entropy forward and backward for Hopper (sm_90a): bf16
// storage on the tensor cores, f32 storage on the CUDA cores. Logits,
// softmax statistics and accumulators are f32 on both routes.
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
// (about 5.6 ms and 16.7 ms at the H100's 989 TFLOP/s in bf16).
//
// bf16 route (namespace tc): GEMMs on wgmma, fed by TMA.
//   Every kernel is one block of three warpgroups: one producer thread
//   issues TMA copies (2-d tensor maps, 128-byte swizzle, zero fill past
//   the tensors' edges) into a ring of 4 stages of 48 KB, each completing
//   on its stage's `full` mbarrier; two consumer warpgroups of 64 rows run
//   wgmma from shared memory and arrive on the stage's `empty` mbarrier
//   when their products have read it. setmaxnreg moves the producers to 40
//   registers and the consumers to 232.
//   Logits GEMM (ce_logits_kernel): M = 128 tokens, N = a vocab tile of
//   256, K = d in stages of 64; wgmma m64n256k16, h and e both K-major.
//   The T x V logits never reach memory: the epilogue folds each tile
//   straight from the accumulator registers.
//   forward  - per token and vocab split, a running max, sum of exp,
//              target logit and best logit / index (each thread over its
//              own columns, the four lanes of a row merged at the end);
//              ce_merge_kernel joins the splits in vocab order (ties keep
//              the first index). Token tiles are the grid's inner
//              dimension, so each e tile is read from memory about once
//              and served from L2 to the token tiles.
//   backward - the vocab in chunks of Vc columns (a power of two the
//              wrapper picks, 32768 at T 4096), three launches a chunk:
//              (a) the logits GEMM again, whose epilogue writes dlogits =
//                  (exp(logit - lse) - onehot) g as bf16 hi + lo (carrying
//                  the f32 value to within 2^-16) into (T, Vc) buffers;
//              (b) dh += dlogits_c . e_c (ce_grad_kernel<false>): M = 128
//                  tokens, N = 128 columns of d, K = Vc, the hi and lo
//                  products from one e tile; e read MN-major;
//              (c) de_c = dlogits_c^T . h (ce_grad_kernel<true>): M = 128
//                  vocab rows, N = 128, K = T; the A operand read
//                  transposed (MN-major) from the same buffers, h MN-major.
//              The tensor cores' f32 accumulation truncates: chained over
//              2,048 vocab tiles it biased dh by about 1e-3 of its size.
//              So each accumulator starts from zero for a slice of 512 of
//              K and joins an f32 register sum through one rounded add;
//              dh's chunk sums join an f32 (T, d) buffer in chunk order,
//              and dh is rounded to bf16 once, after the last chunk. Every
//              output element has one owner: no atomics, and two calls
//              give the same bits. Five products against the bound's three.
//   bf16 rows need d a multiple of 16 and 32-byte-aligned bases (TMA: 16).
//
// f32 route (namespace simt), on no full-width path: the first version,
// f32 FMA on the CUDA cores. Forward: block (64 tokens, one vocab split),
// 64 x 64 logits tiles staged through shared memory, each thread 4 x 4 of
// them. Backward: two launches; a block owns 16 rows (tokens for dh, vocab
// rows for dW) and a 16 x d f32 accumulator in shared memory, and walks
// the other side in tiles of 128 (logits again, then the dlogits product).
//
// The launchers do not synchronise and return cudaGetLastError(); the
// bf16 backward's buffers are scratch the caller allocates.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// partials per (split, token), f32 x 4: max, sum of exp(x - max), target
// logit (0 when the target is in another split), best logit; and int32:
// index of the best logit. One thread a token joins the splits in vocab
// order, so ties keep the first index.
__global__ void __launch_bounds__(256)
ce_merge_kernel(const float* __restrict__ part_f,
                const int* __restrict__ part_i, float* __restrict__ loss,
                float* __restrict__ lse, long long* __restrict__ pred,
                int n_tok, int n_split) {
    const int t = blockIdx.x * 256 + threadIdx.x;
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
// f32 route: CUDA cores
// ---------------------------------------------------------------------------

namespace simt {

constexpr int kThreads = 256;
constexpr int kKC = 32;                // depth of one staged chunk of d

// acc[i][j] = X[tr*TR + i] . Y[tc*TC + j] over d, for the BR rows of X and
// BO rows of Y (row stride d; rows past x_n / y_n read as zero), staged
// through shared memory kKC columns at a time, depth-major so that a thread
// reads its TR and TC operands as neighbours.
template <int BR, int BO, int TR, int TC>
__device__ __forceinline__ void nt_tile(const float* __restrict__ X, int x_n,
                                        const float* __restrict__ Y, int y_n,
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
            a_s[kk * AS + r] =
                (r < x_n && k0 + kk < d) ? X[(long)r * d + k0 + kk] : 0.f;
        }
        for (int i = tid; i < BO * kKC; i += kThreads) {
            const int r = i / kKC, kk = i % kKC;
            b_s[kk * BS + r] =
                (r < y_n && k0 + kk < d) ? Y[(long)r * d + k0 + kk] : 0.f;
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

constexpr int kFwdT = 64, kFwdV = 64, kFwdTR = 4, kFwdTC = 4;

__global__ void __launch_bounds__(kThreads)
ce_fwd_kernel(const float* __restrict__ h, const float* __restrict__ e,
              const long long* __restrict__ y, float* __restrict__ part_f,
              int* __restrict__ part_i, int n_tok, int V, int d,
              int v_per_split) {
    __shared__ float a_s[kKC * (kFwdT + 4)];
    __shared__ float b_s[kKC * (kFwdV + 4)];
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
        nt_tile<kFwdT, kFwdV, kFwdTR, kFwdTC>(h + (long)t0 * d, n_tok - t0,
                                              e + (long)v0 * d, v_end - v0,
                                              d, a_s, b_s, acc);
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

constexpr int kBwdR = 16, kBwdO = 128, kBwdTR = 2, kBwdTC = 4;

// kOwnTokens: the block's 16 rows are tokens and it writes dh; otherwise
// they are vocab rows and it writes dW^T (V, d)
template <bool kOwnTokens>
__global__ void __launch_bounds__(kThreads)
ce_bwd_kernel(const float* __restrict__ h, const float* __restrict__ e,
              const long long* __restrict__ y, const float* __restrict__ lse,
              const float* __restrict__ g, float* __restrict__ out,
              int n_tok, int V, int d) {
    extern __shared__ __align__(16) float smem[];
    float* acc_s = smem;                               // [kBwdR][d]
    float* a_s = acc_s + kBwdR * d;                    // [kKC][kBwdR + 4]
    float* b_s = a_s + kKC * (kBwdR + 4);              // [kKC][kBwdO + 4]
    float* g_s = b_s + kKC * (kBwdO + 4);              // [kBwdO][kBwdR]

    const float* own = kOwnTokens ? h : e;
    const float* oth = kOwnTokens ? e : h;
    const int n_own = kOwnTokens ? n_tok : V;
    const int n_oth = kOwnTokens ? V : n_tok;
    const int tid = threadIdx.x, r0 = blockIdx.x * kBwdR;
    const int tr = tid / (kBwdO / kBwdTC), tc = tid % (kBwdO / kBwdTC);
    for (int i = tid; i < kBwdR * d; i += kThreads) acc_s[i] = 0.f;

    for (int o0 = 0; o0 < n_oth; o0 += kBwdO) {
        const int n_o = min(kBwdO, n_oth - o0);
        float acc[kBwdTR][kBwdTC];
        nt_tile<kBwdR, kBwdO, kBwdTR, kBwdTC>(own + (long)r0 * d, n_own - r0,
                                              oth + (long)o0 * d, n_o, d,
                                              a_s, b_s, acc);
        // dlogits of this tile, other-major: g_s[o][r]
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
                g_s[o * kBwdR + r] = gv;
            }
        __syncthreads();
        // acc_s[r][c] += sum_o g_s[o][r] * oth[o0 + o][c]; each thread owns
        // the column pairs c = 2 tid + 512 m
        const float* yb = oth + (long)o0 * d;
        for (int c = 2 * tid; c < d; c += 2 * kThreads) {
            float p0[kBwdR], p1[kBwdR];
#pragma unroll
            for (int r = 0; r < kBwdR; ++r) p0[r] = p1[r] = 0.f;
#pragma unroll 4
            for (int o = 0; o < n_o; ++o) {
                const float2 yv =
                    *reinterpret_cast<const float2*>(yb + (long)o * d + c);
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
        if (r0 + r < n_own) out[(long)r0 * d + i] = acc_s[i];
    }
}

size_t bwd_smem(int d) {
    return sizeof(float) * ((size_t)kBwdR * d + kKC * (kBwdR + 4) +
                            kKC * (kBwdO + 4) + kBwdO * kBwdR);
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16 route: tensor cores
// ---------------------------------------------------------------------------

namespace tc {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kConsumers = 256, kProducers = 128;
constexpr int kThreads = kConsumers + kProducers;
// 384 threads start with 168 registers each (three warps on each SM
// quarter); the producers give 128 of theirs to the consumers, whose
// logits accumulator alone takes 128
constexpr int kRegs = 168, kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kRows = 128;      // M of a block: two warpgroups of 64 rows
constexpr int kKB = 64;         // K of a stage: one 128-byte swizzled row
constexpr int kVT = 256;        // N of the logits GEMM: a vocab tile
constexpr int kNT = 128;        // N of the dh / de GEMMs: columns of d
constexpr int kStages = 4;
constexpr int kSlice = 8;       // stages a dh / de accumulator sums (K 512)
constexpr int kBwdSplit = 2 * kVT;   // vocab columns a backward block folds
constexpr int kSlab = 64 * 128;      // 64 rows of 128 bytes
constexpr int kStage = 6 * kSlab;    // logits: h 2 slabs, e 4; dh / de: A
                                     // hi 2, A lo 2, B 2
// the ring, its mbarriers, and slack to align the base to 1024 bytes
constexpr size_t kSmem = (size_t)kStages * kStage + 16 * kStages + 1024;

// descriptors of 128-byte swizzled tiles (Swz<64>'s layout): K-major
// (rows 128 bytes apart, K along the row), and MN-major (K along the rows,
// 64 columns of M or N a slab, slabs kSlab bytes apart)
__device__ __forceinline__ uint64_t k_major(uint32_t addr) {
    return wgmma_desc(addr, 16, 1024, 1);
}
__device__ __forceinline__ uint64_t mn_major(uint32_t addr) {
    return wgmma_desc(addr, kSlab, 1024, 1);
}

__device__ __forceinline__ void ring_init(uint64_t* full, uint64_t* empty) {
    if (threadIdx.x == 0) {
        for (int s = 0; s < kStages; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], kConsumers);
        }
        mbar_fence_init();
    }
    __syncthreads();
}

// the producer thread's turn at stage `it`: wait for the consumers to free
// it, then expect `bytes`
__device__ __forceinline__ uint32_t produce(int it, uint32_t ring,
                                           uint64_t* full, uint64_t* empty,
                                           uint32_t bytes) {
    const int st = it % kStages;
    if (it >= kStages) mbar_wait(&empty[st], (it / kStages - 1) & 1);
    mbar_expect_tx(&full[st], bytes);
    return ring + st * kStage;
}

struct LogitsArgs {
    const long long* y;
    const float* lse;       // backward
    const float* g;         // backward
    float* part_f;          // forward: (n_split, T, 4)
    int* part_i;            // forward: (n_split, T)
    bf16* dl_hi;            // backward: (T, ldl), columns from v0
    bf16* dl_lo;
    int ldl, n_tok, d;
    int v0, v_end;          // the vocab columns [v0, v_end)
    int v_per_split;        // a multiple of kVT; blockIdx.y picks the split
};

// this thread's running statistics of its two rows (forward)
struct Stats {
    float m[2], l[2], tgt[2], best[2];
    int arg[2];
};

// fold one 64 x kVT logits tile (this thread: rows i = 0, 1; columns c0 +
// 8 n + 2 t + {0, 1}) into the thread's statistics: its own max and sum of
// exp over the columns it holds, its first best column, and the target's
// logit if it holds that column. Columns at or past v_end are masked.
__device__ __forceinline__ void fold_tile(float* acc, int c0, int v_end,
                                          int t, const long long* yt,
                                          Stats& s) {
    if (c0 + kVT > v_end) {
#pragma unroll
        for (int n = 0; n < kVT / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                if (c0 + 8 * n + 2 * t + (e & 1) >= v_end)
                    acc[4 * n + e] = -INFINITY;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < kVT / 8; ++n)
            mx = fmaxf(mx, fmaxf(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1]));
        if (mx > s.best[i]) {           // earlier tiles win ties
            int col = 0;
#pragma unroll
            for (int n = kVT / 8 - 1; n >= 0; --n)
#pragma unroll
                for (int e = 1; e >= 0; --e)
                    if (acc[4 * n + 2 * i + e] == mx) col = 8 * n + e;
            s.best[i] = mx;
            s.arg[i] = c0 + 2 * t + col;
        }
        const float mn = fmaxf(s.m[i], mx), neg = -mn * kLog2e;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < kVT / 8; ++n)
            sum += exp2f(fmaf(acc[4 * n + 2 * i], kLog2e, neg)) +
                   exp2f(fmaf(acc[4 * n + 2 * i + 1], kLog2e, neg));
        s.l[i] = s.l[i] * exp2f((s.m[i] - mn) * kLog2e) + sum;
        s.m[i] = mn;
        const long long rel = yt[i] - c0 - 2 * t;     // = 8 n + e if held
        if (rel >= 0 && rel < kVT && (rel & 6) == 0) {
            // static indices only: the accumulator stays in registers
            const int n = (int)(rel >> 3);
            const bool odd = rel & 1;
            float x = 0.f;
#pragma unroll
            for (int nn = 0; nn < kVT / 8; ++nn)
                if (nn == n)
                    x = odd ? acc[4 * nn + 2 * i + 1] : acc[4 * nn + 2 * i];
            s.tgt[i] += x;
        }
    }
}

// the four lanes of each row merge their statistics; lane t = 0 writes
// the split's partials
__device__ __forceinline__ void store_stats(const Stats& s, int r0, int t,
                                            const LogitsArgs& a) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        float m = s.m[i];
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        float l = s.l[i] * exp2f((s.m[i] - m) * kLog2e), tg = s.tgt[i];
        float best = s.best[i];
        int arg = s.arg[i];
#pragma unroll
        for (int off = 1; off < 4; off *= 2) {
            l += __shfl_xor_sync(0xffffffffu, l, off);
            tg += __shfl_xor_sync(0xffffffffu, tg, off);
            const float ob = __shfl_xor_sync(0xffffffffu, best, off);
            const int oa = __shfl_xor_sync(0xffffffffu, arg, off);
            if (ob > best || (ob == best && oa < arg)) {
                best = ob;
                arg = oa;
            }
        }
        const int row = r0 + 8 * i;
        if (t == 0 && row < a.n_tok) {
            const long o = (long)blockIdx.y * a.n_tok + row;
            a.part_f[o * 4 + 0] = m;
            a.part_f[o * 4 + 1] = l;
            a.part_f[o * 4 + 2] = tg;
            a.part_f[o * 4 + 3] = best;
            a.part_i[o] = arg;
        }
    }
}

// dlogits = (exp(logit - lse) - onehot) g of one 64 x kVT tile, rounded
// to bf16 hi and lo = bf16(dlogits - hi), into the chunk's buffers
__device__ __forceinline__ void store_dlogits(const float* acc, int c0,
                                              int r0, int t,
                                              const long long* yt,
                                              const float* ls,
                                              const float* gg,
                                              const LogitsArgs& a) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int row = r0 + 8 * i;
        if (row >= a.n_tok) continue;
        const long long rel = yt[i] - c0 - 2 * t;
        const long o = (long)row * a.ldl + (c0 - a.v0) + 2 * t;
#pragma unroll
        for (int n = 0; n < kVT / 8; ++n) {
            float p0 = exp2f(fmaf(acc[4 * n + 2 * i], kLog2e, -ls[i]));
            float p1 = exp2f(fmaf(acc[4 * n + 2 * i + 1], kLog2e, -ls[i]));
            if (rel == 8 * n) p0 -= 1.f;
            if (rel == 8 * n + 1) p1 -= 1.f;
            p0 *= gg[i];
            p1 *= gg[i];
            const uint32_t hi = pack_bf16(p0, p1);
            const __nv_bfloat162 h2 = *reinterpret_cast<const __nv_bfloat162*>(&hi);
            *reinterpret_cast<uint32_t*>(a.dl_hi + o + 8 * n) = hi;
            *reinterpret_cast<uint32_t*>(a.dl_lo + o + 8 * n) =
                pack_bf16(p0 - __low2float(h2), p1 - __high2float(h2));
        }
    }
}

// logits = h . e^T for 128 tokens (blockIdx.x) and the vocab split
// blockIdx.y, a tile of kVT columns at a time; kBwd: dlogits into the
// chunk's buffers, else the split's softmax partials
template <bool kBwd>
__global__ void __launch_bounds__(kThreads, 1)
ce_logits_kernel(const __grid_constant__ CUtensorMap tm_h,
                 const __grid_constant__ CUtensorMap tm_e,
                 const LogitsArgs a) {
    extern __shared__ uint8_t smem_raw[];
    uint8_t* sm = aligned_smem(smem_raw);
    const uint32_t ring = smem_u32(sm);
    uint64_t* full = reinterpret_cast<uint64_t*>(sm + kStages * kStage);
    uint64_t* empty = full + kStages;
    const int tid = threadIdx.x, t0 = blockIdx.x * kRows;
    const int vb = a.v0 + blockIdx.y * a.v_per_split;
    const int ve = min(a.v_end, vb + a.v_per_split);
    const int n_vt = (ve - vb + kVT - 1) / kVT, n_k = (a.d + kKB - 1) / kKB;
    ring_init(full, empty);

    if (tid >= kConsumers) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                     :: "n"(kProducerRegs));
        if (tid != kConsumers) return;
        for (int it = 0; it < n_vt * n_k; ++it) {
            const int k = (it % n_k) * kKB, v = vb + (it / n_k) * kVT;
            const uint32_t s = produce(it, ring, full, empty, kStage);
            tma_load_2d(s, &tm_h, k, t0, &full[it % kStages]);
            tma_load_2d(s + 2 * kSlab, &tm_e, k, v, &full[it % kStages]);
        }
        return;
    }

    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kConsumerRegs));
    const int wg = tid / 128, w = (tid % 128) / 32, lane = tid % 32;
    const int t = lane % 4, r0 = t0 + wg * 64 + w * 16 + lane / 4;
    long long yt[2];
    float ls[2], gg[2];
    Stats st;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int row = r0 + 8 * i;
        yt[i] = row < a.n_tok ? a.y[row] : -1;
        if (kBwd) {
            ls[i] = row < a.n_tok ? a.lse[row] * kLog2e : 0.f;
            gg[i] = row < a.n_tok ? a.g[row] : 0.f;
        }
        st.m[i] = kNegInf;
        st.l[i] = 0.f;
        st.tgt[i] = 0.f;
        st.best[i] = -INFINITY;
        st.arg[i] = vb;
    }
    float acc[kVT / 2];
    for (int vt = 0; vt < n_vt; ++vt) {
        for (int kc = 0; kc < n_k; ++kc) {
            const int it = vt * n_k + kc;
            mbar_wait(&full[it % kStages], (it / kStages) & 1);
            const uint32_t s = ring + (it % kStages) * kStage;
            fence_regs<kVT / 2>(acc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kKB / 16; ++kk)
                wgmma_ss_n256<0, 0>(acc, k_major(s + wg * kSlab + kk * 32),
                                    k_major(s + 2 * kSlab + kk * 32),
                                    kc > 0 || kk > 0);
            wgmma_commit();
            if (kc > 0) {       // the previous stage's products are done
                wgmma_wait<1>();
                mbar_arrive(&empty[(it - 1) % kStages]);
            }
        }
        wgmma_wait<0>();
        fence_regs<kVT / 2>(acc);
        mbar_arrive(&empty[(vt * n_k + n_k - 1) % kStages]);
        const int c0 = vb + vt * kVT;
        if (kBwd)
            store_dlogits(acc, c0, r0, t, yt, ls, gg, a);
        else
            fold_tile(acc, c0, ve, t, yt, st);
    }
    if (!kBwd) store_stats(st, r0, t, a);
}

struct GradArgs {
    float* acc_f;           // dh: the f32 sum of the chunks before, (T, d)
    bf16* out;              // dh (T, d), or de's rows of this chunk
    int n_rows, d;          // M extent (T, or the chunk's vocab rows); N
    int n_k;                // K extent in stages
    int k0;                 // dh: the chunk's first row of e
    int first, last;        // dh: the chunk's place; de: both 1
};

// out[M, N] = (A_hi + A_lo) . B for M = 128 rows (blockIdx.y) and N = 128
// columns of d (blockIdx.x), K in stages of 64, both halves against one B
// tile. dh (kDe false): A = dlogits (T, Vc) K-major, B = e's chunk rows
// MN-major. de (kDe true): A = dlogits^T, read MN-major from the same
// buffers, B = h MN-major. Each accumulator sums a slice of kSlice stages
// from zero and joins an f32 register sum through one rounded add.
template <bool kDe>
__global__ void __launch_bounds__(kThreads, 1)
ce_grad_kernel(const __grid_constant__ CUtensorMap tm_hi,
               const __grid_constant__ CUtensorMap tm_lo,
               const __grid_constant__ CUtensorMap tm_b, const GradArgs a) {
    extern __shared__ uint8_t smem_raw[];
    uint8_t* sm = aligned_smem(smem_raw);
    const uint32_t ring = smem_u32(sm);
    uint64_t* full = reinterpret_cast<uint64_t*>(sm + kStages * kStage);
    uint64_t* empty = full + kStages;
    const int tid = threadIdx.x;
    const int n0 = blockIdx.x * kNT, m0 = blockIdx.y * kRows;
    ring_init(full, empty);

    if (tid >= kConsumers) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                     :: "n"(kProducerRegs));
        if (tid != kConsumers) return;
        // a second slab wholly past the tensor's edge is not copied: the
        // products it would feed are never stored
        const bool a1 = !kDe || m0 + 64 < a.n_rows, b1 = n0 + 64 < a.d;
        const uint32_t bytes = (a1 ? 4 : 2) * kSlab + (b1 ? 2 : 1) * kSlab;
        for (int it = 0; it < a.n_k; ++it) {
            uint64_t* bar = &full[it % kStages];
            const int k = it * kKB;
            const uint32_t s = produce(it, ring, full, empty, bytes);
            if (kDe) {
                tma_load_2d(s, &tm_hi, m0, k, bar);
                tma_load_2d(s + 2 * kSlab, &tm_lo, m0, k, bar);
                if (a1) {
                    tma_load_2d(s + kSlab, &tm_hi, m0 + 64, k, bar);
                    tma_load_2d(s + 3 * kSlab, &tm_lo, m0 + 64, k, bar);
                }
            } else {
                tma_load_2d(s, &tm_hi, k, m0, bar);
                tma_load_2d(s + 2 * kSlab, &tm_lo, k, m0, bar);
            }
            tma_load_2d(s + 4 * kSlab, &tm_b, n0, a.k0 + k, bar);
            if (b1) tma_load_2d(s + 5 * kSlab, &tm_b, n0 + 64, a.k0 + k, bar);
        }
        return;
    }

    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kConsumerRegs));
    const int wg = tid / 128, w = (tid % 128) / 32, lane = tid % 32;
    const int t = lane % 4, r0 = m0 + wg * 64 + w * 16 + lane / 4;
    float acc[kNT / 2], tot[kNT / 2];
#pragma unroll
    for (int i = 0; i < kNT / 2; ++i) tot[i] = 0.f;
    for (int base = 0; base < a.n_k; base += kSlice) {
        const int end = min(a.n_k, base + kSlice);
        for (int it = base; it < end; ++it) {
            mbar_wait(&full[it % kStages], (it / kStages) & 1);
            // this warpgroup's 64 rows of A: K-major rows 64 wg.. (dh), or
            // slab wg (de); k16 steps 32 bytes along a row, or 16 rows down
            const uint32_t s = ring + (it % kStages) * kStage + wg * kSlab;
            const uint32_t b = ring + (it % kStages) * kStage + 4 * kSlab;
            fence_regs<kNT / 2>(acc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kKB / 16; ++kk) {
                const uint32_t ak = kDe ? kk * 2048 : kk * 32;
                const uint64_t db = mn_major(b + kk * 2048);
                const uint64_t dhi = kDe ? mn_major(s + ak) : k_major(s + ak);
                const uint64_t dlo = kDe ? mn_major(s + 2 * kSlab + ak)
                                         : k_major(s + 2 * kSlab + ak);
                wgmma_ss_n128<kDe, 1>(acc, dhi, db, it > base || kk > 0);
                wgmma_ss_n128<kDe, 1>(acc, dlo, db, 1);
            }
            wgmma_commit();
            if (it > base) {    // the previous stage's products are done
                wgmma_wait<1>();
                mbar_arrive(&empty[(it - 1) % kStages]);
            }
        }
        // the slice's sum, from zero, joins the f32 sum
        wgmma_wait<0>();
        fence_regs<kNT / 2>(acc);
        mbar_arrive(&empty[(end - 1) % kStages]);
#pragma unroll
        for (int i = 0; i < kNT / 2; ++i) tot[i] += acc[i];
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int row = r0 + 8 * i;
        if (row >= a.n_rows) continue;
#pragma unroll
        for (int j = 0; j < kNT / 8; ++j) {
            const int col = n0 + 8 * j + 2 * t;
            if (col >= a.d) continue;
            const long o = (long)row * a.d + col;
            float2 v = make_float2(tot[4 * j + 2 * i], tot[4 * j + 2 * i + 1]);
            if (!a.first) {
                const float2 p = *reinterpret_cast<const float2*>(a.acc_f + o);
                v = make_float2(p.x + v.x, p.y + v.y);
            }
            if (a.last)
                *reinterpret_cast<uint32_t*>(a.out + o) = pack_bf16(v.x, v.y);
            else
                *reinterpret_cast<float2*>(a.acc_f + o) = v;
        }
    }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// a TMA map of a row-major (rows, cols) bf16 matrix with a row stride of
// ld elements; its box is box_rows rows of 64 columns, 128-byte swizzled
// (sm90::Swz<64>'s layout); elements past rows or cols read as zero
int map_2d(CUtensorMap* map, const void* base, long rows, long cols,
           long ld, int box_rows) {
    int rc = 0;
    const sm90::EncodeTiled encode = sm90::tensor_map_encoder(&rc);
    if (encode == nullptr) return rc;
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
    const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
    const cuuint32_t step[2] = {1, 1};
    const CUresult res = encode(
        map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
        dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// the shared memory a bf16 kernel needs, and the 168 registers that its
// setmaxnreg moves: a build with fewer would leave its consumers waiting,
// so it is refused
template <typename K>
int tc_ready(K kernel) {
    if (int rc = (int)cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)tc::kSmem))
        return rc;
    cudaFuncAttributes attr;
    if (int rc = (int)cudaFuncGetAttributes(&attr, kernel)) return rc;
    return attr.numRegs == tc::kRegs ? 0 : (int)cudaErrorLaunchOutOfResources;
}

// what the tensor cores need of bf16 rows: d a multiple of 16 and
// 32-byte-aligned bases (the wrapper checks first; this refuses what a
// caller of the C function gets wrong)
bool rows_ok(const void* h, const void* e, int d) {
    const auto aligned = [](const void* p) {
        return (reinterpret_cast<std::uintptr_t>(p) & 31u) == 0;
    };
    return d % 16 == 0 && aligned(h) && aligned(e);
}

int merge(const float* part_f, const int* part_i, float* loss, float* lse,
          long long* pred, int n_tok, int n_split, cudaStream_t st) {
    ce_merge_kernel<<<(n_tok + 255) / 256, 256, 0, st>>>(
        part_f, part_i, loss, lse, pred, n_tok, n_split);
    return (int)cudaGetLastError();
}

int fwd_f32(const float* h, const float* e, const long long* y,
            float* part_f, int* part_i, float* loss, float* lse,
            long long* pred, int n_tok, int V, int d, int v_per_split,
            cudaStream_t st) {
    if (v_per_split % simt::kFwdV) return (int)cudaErrorInvalidValue;
    const int n_split = (V + v_per_split - 1) / v_per_split;
    simt::ce_fwd_kernel<<<dim3((n_tok + simt::kFwdT - 1) / simt::kFwdT,
                               n_split),
                          simt::kThreads, 0, st>>>(
        h, e, y, part_f, part_i, n_tok, V, d, v_per_split);
    if (int rc = (int)cudaGetLastError()) return rc;
    return merge(part_f, part_i, loss, lse, pred, n_tok, n_split, st);
}

int fwd_bf16(const void* h, const void* e, const long long* y,
             float* part_f, int* part_i, float* loss, float* lse,
             long long* pred, int n_tok, int V, int d, int v_per_split,
             cudaStream_t st) {
    if (!rows_ok(h, e, d) || v_per_split % tc::kVT)
        return (int)cudaErrorInvalidValue;
    auto kern = tc::ce_logits_kernel<false>;
    if (int rc = tc_ready(kern)) return rc;
    CUtensorMap th, te;
    if (int rc = map_2d(&th, h, n_tok, d, d, tc::kRows)) return rc;
    if (int rc = map_2d(&te, e, V, d, d, tc::kVT)) return rc;
    tc::LogitsArgs a{};
    a.y = y;
    a.part_f = part_f;
    a.part_i = part_i;
    a.n_tok = n_tok;
    a.d = d;
    a.v0 = 0;
    a.v_end = V;
    a.v_per_split = v_per_split;
    const int n_split = (V + v_per_split - 1) / v_per_split;
    kern<<<dim3((n_tok + tc::kRows - 1) / tc::kRows, n_split), tc::kThreads,
           tc::kSmem, st>>>(th, te, a);
    if (int rc = (int)cudaGetLastError()) return rc;
    return merge(part_f, part_i, loss, lse, pred, n_tok, n_split, st);
}

int bwd_f32(const float* h, const float* e, const long long* y,
            const float* lse, const float* g, float* dh, float* de,
            int n_tok, int V, int d, cudaStream_t st) {
    const size_t bytes = simt::bwd_smem(d);
    auto k_dh = simt::ce_bwd_kernel<true>;
    auto k_de = simt::ce_bwd_kernel<false>;
    if (int rc = (int)cudaFuncSetAttribute(
            k_dh, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes))
        return rc;
    if (int rc = (int)cudaFuncSetAttribute(
            k_de, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes))
        return rc;
    k_dh<<<(n_tok + simt::kBwdR - 1) / simt::kBwdR, simt::kThreads, bytes,
           st>>>(h, e, y, lse, g, dh, n_tok, V, d);
    if (int rc = (int)cudaGetLastError()) return rc;
    k_de<<<(V + simt::kBwdR - 1) / simt::kBwdR, simt::kThreads, bytes, st>>>(
        h, e, y, lse, g, de, n_tok, V, d);
    return (int)cudaGetLastError();
}

int bwd_bf16(const void* h, const void* e, const long long* y,
             const float* lse, const float* g, void* dh, void* de,
             void* dl_hi, void* dl_lo, float* dh_acc, int n_tok, int V,
             int d, int vc, cudaStream_t st) {
    using tc::kRows;
    using bf16 = __nv_bfloat16;
    if (!rows_ok(h, e, d) || vc <= 0 || vc % tc::kVT)
        return (int)cudaErrorInvalidValue;
    auto k_logits = tc::ce_logits_kernel<true>;
    auto k_dh = tc::ce_grad_kernel<false>;
    auto k_de = tc::ce_grad_kernel<true>;
    if (int rc = tc_ready(k_logits)) return rc;
    if (int rc = tc_ready(k_dh)) return rc;
    if (int rc = tc_ready(k_de)) return rc;
    CUtensorMap th, te, te64, th64;
    if (int rc = map_2d(&th, h, n_tok, d, d, kRows)) return rc;
    if (int rc = map_2d(&te, e, V, d, d, tc::kVT)) return rc;
    if (int rc = map_2d(&te64, e, V, d, d, 64)) return rc;
    if (int rc = map_2d(&th64, h, n_tok, d, d, 64)) return rc;
    const int n_chunks = (V + vc - 1) / vc;
    const int n_cols = (d + tc::kNT - 1) / tc::kNT;
    for (int c = 0; c < n_chunks; ++c) {
        const int v0 = c * vc, vn = min(vc, V - v0);
        // (a) the chunk's dlogits
        tc::LogitsArgs la{};
        la.y = y;
        la.lse = lse;
        la.g = g;
        la.dl_hi = (bf16*)dl_hi;
        la.dl_lo = (bf16*)dl_lo;
        la.ldl = vc;
        la.n_tok = n_tok;
        la.d = d;
        la.v0 = v0;
        la.v_end = v0 + vn;
        la.v_per_split = tc::kBwdSplit;
        k_logits<<<dim3((n_tok + kRows - 1) / kRows,
                        (vn + tc::kBwdSplit - 1) / tc::kBwdSplit),
                   tc::kThreads, tc::kSmem, st>>>(th, te, la);
        if (int rc = (int)cudaGetLastError()) return rc;
        // the buffers as (T, vn) matrices: nothing past the chunk is read
        CUtensorMap hi, lo, hi64, lo64;
        if (int rc = map_2d(&hi, dl_hi, n_tok, vn, vc, kRows)) return rc;
        if (int rc = map_2d(&lo, dl_lo, n_tok, vn, vc, kRows)) return rc;
        if (int rc = map_2d(&hi64, dl_hi, n_tok, vn, vc, 64)) return rc;
        if (int rc = map_2d(&lo64, dl_lo, n_tok, vn, vc, 64)) return rc;
        // (b) dh joins the chunk's sum
        tc::GradArgs ga{};
        ga.acc_f = dh_acc;
        ga.out = (bf16*)dh;
        ga.n_rows = n_tok;
        ga.d = d;
        ga.n_k = (vn + tc::kKB - 1) / tc::kKB;
        ga.k0 = v0;
        ga.first = c == 0;
        ga.last = c == n_chunks - 1;
        k_dh<<<dim3(n_cols, (n_tok + kRows - 1) / kRows), tc::kThreads,
               tc::kSmem, st>>>(hi, lo, te64, ga);
        if (int rc = (int)cudaGetLastError()) return rc;
        // (c) the chunk's rows of de
        tc::GradArgs gb{};
        gb.out = (bf16*)de + (long)v0 * d;
        gb.n_rows = vn;
        gb.d = d;
        gb.n_k = (n_tok + tc::kKB - 1) / tc::kKB;
        gb.first = gb.last = 1;
        k_de<<<dim3(n_cols, (vn + kRows - 1) / kRows), tc::kThreads,
               tc::kSmem, st>>>(hi64, lo64, th64, gb);
        if (int rc = (int)cudaGetLastError()) return rc;
    }
    return 0;
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores). part_f
// (n_split, T, 4) f32 and part_i (n_split, T) int32 are scratch the caller
// allocates, n_split = ceil(V / v_per_split); v_per_split is a multiple of
// 64 (f32) or 256 (bf16). bf16 rows need d a multiple of 16 and
// 32-byte-aligned h and e, else cudaErrorInvalidValue.
extern "C" int repro_ce_fwd(const void* h, const void* e, const void* y,
                            void* part_f, void* part_i, void* loss, void* lse,
                            void* pred, int n_tok, int V, int d,
                            int v_per_split, int dtype, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const long long* yy = (const long long*)y;
    if (dtype == 0)
        return fwd_f32((const float*)h, (const float*)e, yy, (float*)part_f,
                       (int*)part_i, (float*)loss, (float*)lse,
                       (long long*)pred, n_tok, V, d, v_per_split, st);
    return fwd_bf16(h, e, yy, (float*)part_f, (int*)part_i, (float*)loss,
                    (float*)lse, (long long*)pred, n_tok, V, d, v_per_split,
                    st);
}

// d must be even (bf16: as for repro_ce_fwd); dh (T, d) and de (V, d) in
// the inputs' dtype. bf16 only: dl_hi and dl_lo are (T, vc) bf16 scratch,
// vc a multiple of 256, the vocab chunk; dh_acc is (T, d) f32 scratch,
// read only when V > vc. f32 ignores the four.
extern "C" int repro_ce_bwd(const void* h, const void* e, const void* y,
                            const void* lse, const void* g, void* dh,
                            void* de, void* dl_hi, void* dl_lo, void* dh_acc,
                            int n_tok, int V, int d, int vc, int dtype,
                            void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const long long* yy = (const long long*)y;
    if (dtype == 0)
        return bwd_f32((const float*)h, (const float*)e, yy,
                       (const float*)lse, (const float*)g, (float*)dh,
                       (float*)de, n_tok, V, d, st);
    return bwd_bf16(h, e, yy, (const float*)lse, (const float*)g, dh, de,
                    dl_hi, dl_lo, (float*)dh_acc, n_tok, V, d, vc, st);
}
