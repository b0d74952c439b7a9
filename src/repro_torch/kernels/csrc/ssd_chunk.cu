// Mamba-2 SSD intra-chunk block, forward and backward, for Hopper (sm_90a):
// f32 storage, every product on the tensor cores as three TF32 products
// with f32 accumulation ("3xTF32").
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
// Layout: a, da (BH, S); x, y, dx, dy (BH, S, P); b, c, db, dc (B, S, N),
// shared by the H heads of a batch row: head bh reads row bh / H, and
// nothing is broadcast per head. L <= 256 and P <= 64 (the wrappers check);
// N is any. Scratch the backward's caller allocates: dgp (B, nc, ngroups,
// 64 nt, 64 nt), one dG sum per head group; rpart (BH, nc, nt, L); cpart
// (BH, nc, L); nt = ceil(L / 64).
//
// Precision. Each f32 operand v is split into big = rna(v) and small =
// rna(v - big), rna the round to nearest TF32 (ties away from zero) that
// cvt.rna.tf32.f32 gives, done by two integer ops; the tensor core itself
// would truncate an unrounded f32, a different split. A product is
// small.big + big.small + big.big summed in f32. Emulated on the CPU at
// the full-width chunk against the f64 plain version
// (tests/test_torch_ssd.py), y reads 2.467e-6 that way and 2.466e-6 in
// plain f32, but 4.066e-4 with one TF32 product, 40x the forward's 1e-5
// limit (the gradients 3.7e-4 to 4.3e-4 against 1e-4): one TF32 product,
// or bf16, is excluded. The tensor core's sum truncates, so no accumulator
// runs over more than 64 of K from zero: each 64-deep partial joins an f32
// sum by a rounded add.
//
// Bound on the card. At mamba2-780m's full width (H 48, P 64, N 128, L 256,
// S 4096) the forward does 3.37e9 flop over the causal pairs and moves
// 105.6 MB, the backward 6.87e9 and 161.0 MB. At 3x the operations at the
// dense TF32 rate (495 TFLOP/s) the bytes bind both: 0.0315 / 0.0480 ms
// (0.0503 / 0.1026 ms at the CUDA cores' f32 rate). What binds these
// kernels is neither: they issue several instructions (the split, the
// decay, the shared loads) for each mma.sync product, and 8 warps on an SM
// hide little of the latency between them.
//
// Route. Every product is mma.sync.m16n8k8 TF32 (HMMA). wgmma would take
// .tf32 operands from shared memory K-major only, while X (for Y = M.X
// and dX's M^T.dY), dY, B and C are stored MN-major for their products:
// it would need split, transposed copies of them, which the backward's
// 220 KiB of shared memory leaves no room for, and which bought the
// forward about 3 % (PERF.md). mma.sync reads one f32 copy of every
// operand in either orientation and splits it in registers. Its tiles are
// 64 x 64 f32 with an XOR swizzle on the column (tix) under which both the
// row-major fragment walk (row g, column t) and the transposed one (row t,
// column g) of a warp hit 32 distinct banks, so one copy serves both; each
// lane's offsets for either walk are computed once (Walk), so every shared
// load in a product is a register plus a constant.
//
// Design:
//   - ssd_fwd_kernel, one launch a call: a block owns (batch row, chunk,
//     a pair of row tiles q and nt-1-q, a group of heads), one block an SM
//     with two warpgroups. Pairing balances the causal triangle (tile 3
//     has 4x the work of tile 0 at L 256); the head groups fill the card.
//     The block sums the chunk's cumsum of a for its heads, each head
//     sequentially in one thread, as the CPU cumsum does; forms its rows of
//     G = C.B^T (every operand tile of a 64-column slice of N loaded at
//     once) and keeps them in shared memory; then each warpgroup takes
//     every other head: X's tiles come through a two-stage cp.async ring,
//     M = G o exp(cum_i - cum_j) is built straight into the A fragments,
//     and Y_h = M.X_h runs 16 rows a warp. Y is written once.
//   - ssd_bwd_kernel, the fused pass over the heads: a block owns (batch
//     row, chunk, a pair of column tiles, a head group), holds its G
//     column band and an f32 dG sum band in shared memory, and per head
//     and row tile runs dM = dY.X^T, then dG_h = dM o decay (added to the
//     band in a fixed head order), M = G o decay into a shared tile, the
//     row and column sums of Q = dG_h o G (row sums per column tile into
//     rpart, column sums complete into cpart), and dX = M^T.dY. dY and X
//     come through cp.async rings. Each block writes its group's dG band.
//   - ssd_dbc_kernel: dC = dGs.B and dB = dGs^T.C per (chunk, tile,
//     64 columns of N), dGs the sum of the groups' bands in group order;
//     its last blocks compute da, the reverse cumsum within the chunk of
//     dcum = (row sums) - (column sums), one warp a (head, chunk) row.
//   - exp(cum_i - cum_j) is taken of the difference (expf, as the plain
//     version does), never as exp(cum_i) exp(-cum_j), which
//     overflows once a chunk's decay passes -88. Above the diagonal the
//     difference is replaced by -inf, and the cumsum past L is -1e30, so
//     those terms are exactly 0 and never inf * 0 = NaN.
//   - every sum has one owner and a fixed order: the backward is
//     deterministic without atomics.
// The launchers allocate nothing, do not synchronise, and return
// cudaGetLastError().

#include "sm90.cuh"

#include <cstdint>

namespace {

using sm90::cp_async16;
using sm90::cp_async_commit;
using sm90::cp_async_wait;
using sm90::smem_u32;

constexpr int kT = 64;                  // tile edge
constexpr int kTile = kT * kT;          // floats in one tile
constexpr int kMaxL = 4 * kT;
constexpr int kMaxP = kT;
constexpr int kMaxHeads = 32;           // heads a block (a cumsum thread each)
constexpr int kSmemMax = 232448;        // a block's shared memory on sm_90
constexpr float kPad = -1e30f;          // cumsum past L: exp(pad - cum) = 0

__device__ __forceinline__ float neg_inf() {
    return __int_as_float(0xff800000);
}

// Tiles are 64 x 64 f32, element (r, c) at r * 64 + (c ^ swz(r)) with
// swz(r) = (r & 3) << 3 | (r & 4): a warp reading rows g, columns t
// (g < 8, t < 4, the row-major fragment walk) and one reading rows t,
// columns g (the transposed walk) both hit 32 banks, and 4-aligned runs of
// columns stay contiguous for 16-byte copies.
__device__ __forceinline__ int tix(int r, int c) {
    return r * kT + (c ^ (((r & 3) << 3) | (r & 4)));
}

// A lane's offsets into a tile for the fragment walks of mma.sync.m16n8k8
// (g = lane / 4, t = lane % 4), so that every shared load in the products
// is a register plus a constant:
//   r(R, m, q): element (8R + g, 8m + t + 4q), the row-major walk;
//   c(m, n, q): element (8m + t + 4q, 8n + g), the transposed walk;
//   f(R, n):    element (8R + g, 8n + 2t), the accumulator's pair.
// R, m, n and q are compile-time constants at every call (unrolled loops).
struct Walk {
    int rk[4][2], kc[4][2], cf[4];
    __device__ __forceinline__ explicit Walk(int lane) {
        const int g = lane / 4, t = lane % 4, g2 = g >> 2, g01 = g & 3;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                rk[u][q] = g * kT + t + 4 * (q ^ g2) + 8 * (u ^ g01);
                kc[u][q] = kT * t + 256 * q + g01 + 4 * (g2 ^ q) +
                           8 * (u ^ t);
            }
            cf[u] = g * kT + 2 * (t & 1) + 4 * ((t >> 1) ^ g2) +
                    8 * (u ^ g01);
        }
    }
    __device__ __forceinline__ int r(int R, int m, int q) const {
        return rk[m & 3][q] + 32 * (m >> 2) + 512 * R;
    }
    __device__ __forceinline__ int c(int m, int n, int q) const {
        return kc[n & 3][q] + 32 * (n >> 2) + 512 * m;
    }
    __device__ __forceinline__ int f(int R, int n) const {
        return cf[n & 3] + 32 * (n >> 2) + 512 * R;
    }
};

// element (8m + t + 4q, 8cn + g) for a runtime column block cn: the
// transposed walk of an A operand whose rows start at a runtime offset
__device__ __forceinline__ int walk_c(int lane, int cn, int q) {
    const int g = lane / 4, t = lane % 4;
    return kT * t + 256 * q + (g & 3) + 4 * ((g >> 2) ^ q) +
           8 * ((cn & 3) ^ t) + 32 * (cn >> 2);
}

// 4 bytes global -> shared; zero-fills when !valid (src is not read)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// rows [0, rows) x columns [0, cols) of src (row stride ld floats) into a
// swizzled tile, zero elsewhere; 16-byte copies when vec (ld and cols
// multiples of 4, src 16-byte aligned), else 4-byte ones
template <int NT>
__device__ __forceinline__ void load_tile(float* tile, const float* src,
                                          long ld, int rows, int cols,
                                          bool vec, int tid = threadIdx.x) {
    if (vec) {
#pragma unroll
        for (int e = tid; e < kTile / 4; e += NT) {
            const int r = e / 16, c = (e % 16) * 4;
            const bool ok = r < rows && c < cols;
            cp_async16(smem_u32(tile + tix(r, c)),
                       ok ? src + (long)r * ld + c : src, ok);
        }
    } else {
        for (int e = tid; e < kTile; e += NT) {
            const int r = e / kT, c = e % kT;
            const bool ok = r < rows && c < cols;
            cp_async4(smem_u32(tile + tix(r, c)),
                      ok ? src + (long)r * ld + c : src, ok);
        }
    }
}

// ---------------------------------------------------------------------------
// 3xTF32 products on mma.sync.m16n8k8: A (16 x 8) a0 = (g, t), a1 = (g + 8,
// t), a2 = (g, t + 4), a3 = (g + 8, t + 4); B (8 x 8) b0 = (t, g), b1 =
// (t + 4, g); C (16 x 8) c0, c1 = row g, columns 2t, 2t + 1; c2, c3 = row
// g + 8.
// ---------------------------------------------------------------------------

// round to nearest TF32, ties away from zero: bit for bit what
// cvt.rna.tf32.f32 gives a finite value, without the inf / NaN test the
// compiler wraps around it (two instructions instead of four)
__device__ __forceinline__ uint32_t rna_tf32(float v) {
    return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

struct Split {
    uint32_t big, small;
};

// v = big + small, each rounded to nearest TF32
__device__ __forceinline__ Split split(float v) {
    const uint32_t big = rna_tf32(v);
    return {big, rna_tf32(v - __uint_as_float(big))};
}

__device__ __forceinline__ void mma_tf32(float* d, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d[n] += A.B_n over one k-step of 8 in 3xTF32: the small products of
// every n first, then big.big, so that consecutive products go to
// different accumulators
template <int NN>
__device__ __forceinline__ void mma3(float (&d)[NN][4], const Split (&a)[4],
                                     const Split (&b)[NN][2]) {
#pragma unroll
    for (int n = 0; n < NN; ++n)
        mma_tf32(d[n], a[0].small, a[1].small, a[2].small, a[3].small,
                 b[n][0].big, b[n][1].big);
#pragma unroll
    for (int n = 0; n < NN; ++n)
        mma_tf32(d[n], a[0].big, a[1].big, a[2].big, a[3].big,
                 b[n][0].small, b[n][1].small);
#pragma unroll
    for (int n = 0; n < NN; ++n)
        mma_tf32(d[n], a[0].big, a[1].big, a[2].big, a[3].big, b[n][0].big,
                 b[n][1].big);
}

template <int NN>
__device__ __forceinline__ void zero(float (&d)[NN][4]) {
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[n][e] = 0.f;
}

// acc += part, rounded f32 adds: the tensor core's own sum truncates, so
// no accumulator runs over more than 64 of K from zero
template <int NN>
__device__ __forceinline__ void join(float (&acc)[NN][4],
                                     const float (&part)[NN][4]) {
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
}

template <int N>
struct Int {
    static constexpr int value = N;
};

// f(Int<m>) for the k-steps m in [mb, me) of a 64-deep tile: all eight
// unguarded, one straight run the compiler can schedule across, when the
// range is whole; each behind its own test otherwise
template <class F>
__device__ __forceinline__ void for_steps(const F& f, int mb, int me) {
    if (mb == 0 && me >= 8) {
        f(Int<0>()); f(Int<1>()); f(Int<2>()); f(Int<3>());
        f(Int<4>()); f(Int<5>()); f(Int<6>()); f(Int<7>());
    } else {
        if (mb <= 0 && 0 < me) f(Int<0>());
        if (mb <= 1 && 1 < me) f(Int<1>());
        if (mb <= 2 && 2 < me) f(Int<2>());
        if (mb <= 3 && 3 < me) f(Int<3>());
        if (mb <= 4 && 4 < me) f(Int<4>());
        if (mb <= 5 && 5 < me) f(Int<5>());
        if (mb <= 6 && 6 < me) f(Int<6>());
        if (mb <= 7 && 7 < me) f(Int<7>());
    }
}

// A (rows of tile s, k) and B (k, columns = rows of tile b) in the
// row-major walk: d[n] += s[., k] b[8n + ., k]^T for one k-step m
template <int NN, int M>
__device__ __forceinline__ void step_rows_rows(float (&d)[NN][4],
                                               const float* s,
                                               const float* b,
                                               const Walk& w) {
    Split a[4], bs[NN][2];
#pragma unroll
    for (int e = 0; e < 4; ++e) a[e] = split(s[w.r(e & 1, M, e >> 1)]);
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int q = 0; q < 2; ++q) bs[n][q] = split(b[w.r(n, M, q)]);
    mma3(d, a, bs);
}

// rows r0 + g (+ 8), columns c0 + 8n + 2t (+ 1) of an accumulator set
// into dst (row stride ld), where row < rows and column < cols
template <int NN>
__device__ __forceinline__ void store_frags(float* dst, long ld,
                                            const float (&d)[NN][4], int r0,
                                            int c0, int rows, int cols,
                                            int lane) {
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = r0 + g + 8 * h, q = c0 + 8 * n + 2 * t;
            if (r >= rows) continue;
            float* p = dst + (long)r * ld + q;
            if (q + 1 < cols) {
                p[0] = d[n][2 * h];
                p[1] = d[n][2 * h + 1];
            } else if (q < cols) {
                p[0] = d[n][2 * h];
            }
        }
}

// the same into a swizzled shared tile (pointer at its row r0, column c0),
// every element
template <int NN>
__device__ __forceinline__ void store_frags_smem(float* tile,
                                                 const float (&d)[NN][4],
                                                 const Walk& w) {
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(tile + w.f(h, n)) =
                make_float2(d[n][2 * h], d[n][2 * h + 1]);
}

// The in-chunk cumsum of a for the heads of a block (nh rows of a from
// row0, stride S) into cum (row stride lc; kPad past L). Loaded coalesced,
// then each head summed sequentially by one thread, in the order of the
// CPU cumsum.
template <int NT>
__device__ __forceinline__ void chunk_cumsum(float* cum, const float* a,
                                             long row0, int S, int L, int lc,
                                             int nh) {
    for (int e = threadIdx.x; e < nh * lc; e += NT) {
        const int h = e / lc, l = e % lc;
        cum[e] = l < L ? a[row0 + (long)h * S + l] : kPad;
    }
    __syncthreads();
    if (threadIdx.x < nh) {
        float* row = cum + threadIdx.x * lc;
        float s = 0.f;
        for (int l0 = 0; l0 < L; l0 += 8) {
            float v[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) v[u] = row[l0 + u];
#pragma unroll
            for (int u = 0; u < 8; ++u)
                if (l0 + u < L) {
                    s += v[u];
                    row[l0 + u] = s;
                }
        }
    }
    __syncthreads();
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// The G tiles u = u0 .. u1 of a band, into band + u * kTile (64 x 64
// each): G(f, u) = F . V_u^T where F is the band's fixed side (C_it
// forward) when FIXED_A, else G(u, f) = V_u . F^T (B_jt backward). Per 64
// columns of N every operand tile is loaded at once: F into stage, V_u
// into stage + (1 + u - u0) tiles. Warp group grp of ngrp takes tiles
// u0 + grp, u0 + grp + ngrp, ..; its warp (r0, c0) a 16 x 32 corner.
template <int NT, bool FIXED_A>
__device__ __forceinline__ void gram_band(float* band, float* stage,
                                          const float* fixed, int rows_f,
                                          const float* var, int u0, int u1,
                                          int L, int N, bool vec, int grp,
                                          int ngrp, int r0, int c0,
                                          const Walk& w) {
    for (int n0 = 0; n0 < N; n0 += kT) {
        load_tile<NT>(stage, fixed + n0, N, rows_f, N - n0, vec);
        for (int u = u0; u <= u1; ++u)
            load_tile<NT>(stage + (1 + u - u0) * kTile,
                          var + (long)u * kT * N + n0, N, L - u * kT, N - n0,
                          vec);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        const int nk = (min(kT, N - n0) + 7) / 8;
        for (int u = u0 + grp; u <= u1; u += ngrp) {
            const float* vt = stage + (1 + u - u0) * kTile;
            const float* sa = (FIXED_A ? stage : vt) + r0 * kT;
            const float* sb = (FIXED_A ? vt : stage) + c0 * kT;
            float part[4][4];
            zero(part);
            for_steps([&](auto m) {
                step_rows_rows<4, decltype(m)::value>(part, sa, sb, w);
            }, 0, nk);
            float* gt = band + u * kTile + r0 * kT + c0;
            if (n0 > 0) {               // join the slices by rounded adds
#pragma unroll
                for (int n = 0; n < 4; ++n)
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const float2 v =
                            *reinterpret_cast<const float2*>(gt + w.f(h, n));
                        part[n][2 * h] += v.x;
                        part[n][2 * h + 1] += v.y;
                    }
            }
            store_frags_smem(gt, part, w);
        }
        __syncthreads();
    }
}

constexpr int kFwdThreads = 256;        // 2 warpgroups, a head stream each
constexpr int kGroupThreads = 128;      // a warpgroup: 4 warps, 16 rows each

// shared memory of the forward (floats): nt G tiles, then a region that
// stages the G products' operands (C_it and B_0 .. B_it of a 64-column
// slice of N) and then holds two raw X tiles a warpgroup (its cp.async
// ring); then hg cumsum rows
__host__ __device__ constexpr int fwd_fixed_floats(int nt) {
    return (nt + (nt + 1 > 4 ? nt + 1 : 4)) * kTile;
}

// barrier of one warpgroup (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int grp) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(1 + grp), "r"(kGroupThreads)
                 : "memory");
}

// Y part += M . X_jt for one k-step m over j: A = this warp's 16 rows of
// M = G o exp(cum_i - cum_j), built from G and split in registers (on the
// diagonal tile the exponent is taken of -inf where j > i); B = X (rows j,
// columns p) in the transposed walk. A chunk's ragged end needs no test:
// X's rows past L are 0, and M's columns past L lie above the diagonal or
// in rows past L, where G is 0 and the cumsum pad makes the exponent 0.
template <int M>
__device__ __forceinline__ void y_step(float (&part)[8][4], const float* gt,
                                       const float* cmj, float ca, float cb,
                                       int il, int t, bool diag,
                                       const float* xs, const Walk& w) {
    const float ja = cmj[8 * M], jb = cmj[8 * M + 4];
    const int j = 8 * M + t;
    const float e[4] = {diag && j > il ? neg_inf() : ca - ja,
                        diag && j > il + 8 ? neg_inf() : cb - ja,
                        diag && j + 4 > il ? neg_inf() : ca - jb,
                        diag && j + 4 > il + 8 ? neg_inf() : cb - jb};
    Split a[4], b[8][2];
#pragma unroll
    for (int q = 0; q < 4; ++q)
        a[q] = split(gt[w.r(q & 1, M, q >> 1)] * expf(e[q]));
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int q = 0; q < 2; ++q) b[n][q] = split(xs[w.c(M, n, q)]);
    mma3(part, a, b);
}

// Y for row tiles q and nt-1-q of chunk blockIdx.y % nc, batch row
// blockIdx.y / nc, heads blockIdx.z * hg ..; grid (ceil(nt / 2), B nc,
// ceil(H / hg)), one block an SM. Its 8 warps form G (16 x 32 each); then
// each warpgroup takes every other head, a warp 16 rows of a Y tile.
__global__ void __launch_bounds__(kFwdThreads, 1)
ssd_fwd_kernel(const float* __restrict__ a, const float* __restrict__ x,
               const float* __restrict__ b, const float* __restrict__ c,
               float* __restrict__ y, int H, int S, int L, int P, int N,
               int hg, int vx, int vbc) {
    extern __shared__ __align__(16) float smem[];
    const int nt = (L + kT - 1) / kT, nc = S / L, lc = nt * kT + 1;
    float* gs = smem;
    float* stage = gs + nt * kTile;
    float* cum = smem + fwd_fixed_floats(nt);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int grp = warp / 4, gtid = threadIdx.x % kGroupThreads;
    const int g = lane / 4, t = lane % 4;
    const int r0 = 16 * (warp % 4);             // this warp's 16 rows
    const Walk w(lane);
    const int bb = blockIdx.y / nc, ch = blockIdx.y % nc;
    const int h0 = blockIdx.z * hg, nh = min(hg, H - h0);
    const long brow = (long)bb * S + (long)ch * L;        // b, c rows
    const long hrow = (long)(bb * H + h0) * S + (long)ch * L;
    float* ring = stage + grp * 2 * kTile;      // two raw X tiles

    chunk_cumsum<kFwdThreads>(cum, a, hrow, S, L, lc, nh);

    for (int pass = 0; pass < 2; ++pass) {
        const int it = pass == 0 ? blockIdx.x : nt - 1 - blockIdx.x;
        if (pass == 1 && it == (int)blockIdx.x) break;
        const int i0 = it * kT;

        // G(it, jt) = C_it . B_jt^T for jt <= it, kept in gs
        gram_band<kFwdThreads, true>(gs, stage, c + (brow + i0) * N, L - i0,
                                     b + brow * N, 0, it, L, N, vbc, 0, 1,
                                     16 * (warp >> 1), 32 * (warp & 1), w);

        // per head of this warpgroup: Y_h = sum_jt M(it, jt) . X_h(jt)
        const int per = it + 1, items = ((nh - grp + 1) / 2) * per;
        auto issue = [&](int k) {
            const int h = grp + 2 * (k / per), jt = k % per;
            load_tile<kGroupThreads>(ring + (k & 1) * kTile,
                                     x + (hrow + (long)h * S + jt * kT) * P,
                                     P, L - jt * kT, P, vx, gtid);
            cp_async_commit();
        };
        if (items > 0) issue(0);
        float acc[8][4], part[8][4];
        zero(acc);
        const int il = r0 + g;                  // this thread's local row
        for (int k = 0; k < items; ++k) {
            const int h = grp + 2 * (k / per), jt = k % per;
            cp_async_wait<0>();
            group_sync(grp);            // tile k in; tile k - 1 read
            if (k + 1 < items) issue(k + 1);
            const float* cm = cum + h * lc;
            const float ca = cm[i0 + il], cb = cm[i0 + il + 8];
            const bool diag = jt == it;
            // on the diagonal tile, the k-steps past this warp's rows
            // give M = 0
            zero(part);
            for_steps([&](auto m) {
                y_step<decltype(m)::value>(part, gs + jt * kTile + r0 * kT,
                                           cm + jt * kT + t, ca, cb, il, t,
                                           diag, ring + (k & 1) * kTile, w);
            }, 0, diag ? (r0 + 16) / 8 : 8);
            join(acc, part);
            if (diag) {
                store_frags(y + (hrow + (long)h * S + i0) * P, P, acc, r0, 0,
                            L - i0, P, lane);
                zero(acc);
            }
        }
        __syncthreads();        // the staging region is G's again
    }
}

// ---------------------------------------------------------------------------
// backward: the fused pass over the heads
// ---------------------------------------------------------------------------

constexpr int kBwdThreads = 256;        // 8 warps: 4 row x 2 column groups

// shared memory of the backward (floats): G band, dG band, dY ring, X ring
// (by head parity), the M tile, the row (2 x 64) and column (4 x 64)
// partial sums, then hg cumsum rows
__host__ __device__ constexpr int bwd_fixed_floats(int nt) {
    return (2 * nt + 5) * kTile + 6 * kT;
}

// dX part += M^T . dY_it for one k-step m over i: A = M^T (rows j from the
// M tile's columns, offsets ax), B = dY (columns p)
template <int M>
__device__ __forceinline__ void dx_step(float (&part)[4][4], const float* mt,
                                        const float* ys, const int (&ax)[2][2],
                                        const Walk& w) {
    Split a[4], b[4][2];
#pragma unroll
    for (int e = 0; e < 4; ++e)
        a[e] = split(mt[ax[e & 1][e >> 1] + 512 * M]);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int q = 0; q < 2; ++q) b[n][q] = split(ys[w.c(M, n, q)]);
    mma3(part, a, b);
}

// grid (ceil(nt / 2), B nc, ngroups), ngroups = ceil(H / hg)
__global__ void __launch_bounds__(kBwdThreads)
ssd_bwd_kernel(const float* __restrict__ a, const float* __restrict__ x,
               const float* __restrict__ b, const float* __restrict__ c,
               const float* __restrict__ dy, float* __restrict__ dx,
               float* __restrict__ dgp, float* __restrict__ rpart,
               float* __restrict__ cpart, int H, int S, int L, int P, int N,
               int hg, int vx, int vbc) {
    extern __shared__ __align__(16) float smem[];
    const int nt = (L + kT - 1) / kT, nc = S / L, lc = nt * kT + 1;
    const int ld = nt * kT;                     // dgp's row stride
    float* gband = smem;                        // G(it, jt), it >= jt
    float* dband = gband + nt * kTile;          // sum_h dG_h(it, jt)
    float* ring = dband + nt * kTile;           // dY tiles
    float* xring = ring + 2 * kTile;            // X tiles, by head parity
    float* mt = xring + 2 * kTile;              // M(it, jt) of one head
    float* red_row = mt + kTile;                // [2][64]
    float* red_col = red_row + 2 * kT;          // [4][64]
    float* cum = red_col + 4 * kT;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int wr = warp >> 1, wc = warp & 1;
    const int r0 = 16 * wr, c0 = 32 * wc;       // this warp's 16 x 32
    const Walk w(lane);
    // M^T's A fragment: element (8m + t + 4q, r0 + 8h + g) of the M tile
    int ax[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < 2; ++q) ax[h][q] = walk_c(lane, 2 * wr + h, q);
    const int bb = blockIdx.y / nc, ch = blockIdx.y % nc;
    const int grp = blockIdx.z, ngroups = gridDim.z;
    const int h0 = grp * hg, nh = min(hg, H - h0);
    const long brow = (long)bb * S + (long)ch * L;
    const long hrow = (long)(bb * H + h0) * S + (long)ch * L;
    const int nkp = (P + 7) / 8;                // k-steps over p

    chunk_cumsum<kBwdThreads>(cum, a, hrow, S, L, lc, nh);

    for (int pass = 0; pass < 2; ++pass) {
        const int jt = pass == 0 ? blockIdx.x : nt - 1 - blockIdx.x;
        if (pass == 1 && jt == (int)blockIdx.x) break;
        const int j0 = jt * kT, per = nt - jt;

        // G(it, jt) = C_it . B_jt^T for it >= jt (staged in the rings and
        // the M tile); the dG band to 0
        gram_band<kBwdThreads, false>(gband, ring, b + (brow + j0) * N,
                                      L - j0, c + brow * N, jt, nt - 1, L, N,
                                      vbc, 0, 1, r0, c0, w);
        for (int it = jt; it < nt; ++it) {
            float z[4][4];
            zero(z);
            store_frags_smem(dband + it * kTile + r0 * kT + c0, z, w);
        }
        __syncthreads();

        // per head h and row tile it >= jt
        const int items = nh * per;
        auto issue = [&](int k) {
            const int h = k / per, it = jt + k % per;
            const long hr = hrow + (long)h * S;
            load_tile<kBwdThreads>(ring + (k & 1) * kTile,
                                   dy + (hr + it * kT) * P, P, L - it * kT,
                                   P, vx);
            if (it == jt)
                load_tile<kBwdThreads>(xring + (h & 1) * kTile,
                                       x + (hr + j0) * P, P, L - j0, P, vx);
            cp_async_commit();
        };
        issue(0);
        float dxa[4][4], part[4][4];
        zero(dxa);
        float colacc = 0.f;                     // tid 64..127: column sum
        for (int k = 0; k < items; ++k) {
            const int h = k / per, it = jt + k % per, i0 = it * kT;
            const long hr = hrow + (long)h * S;
            if (k + 1 < items) {
                issue(k + 1);
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            __syncthreads();
            const float* ys = ring + (k & 1) * kTile;
            const float* xs = xring + (h & 1) * kTile;
            const float* cm = cum + h * lc;
            const bool diag = it == jt;

            // dM = dY_it . X_jt^T (rows r0.., columns c0..); on the
            // diagonal tile the warps wholly above it skip the products
            float dm[4][4];
            zero(dm);
            if (!diag || c0 <= r0 + 15) {
                const float* ya = ys + r0 * kT;
                const float* xb = xs + c0 * kT;
                for_steps([&](auto m) {
                    step_rows_rows<4, decltype(m)::value>(dm, ya, xb, w);
                }, 0, nkp);
            }

            // decay, M, dG_h, and Q = dG_h o G's row and column sums
            const int tb = r0 * kT + c0;        // this warp's corner
            const float* gt = gband + it * kTile + tb;
            float* dgt = dband + it * kTile + tb;
            float* mw = mt + tb;
            float rs[2] = {0.f, 0.f}, cs[4][2];
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                const int il = r0 + g + 8 * hh;
                const float ci = cm[i0 + il];
#pragma unroll
                for (int n = 0; n < 4; ++n) {
                    const int jl = c0 + 8 * n + 2 * t;
                    float x0 = ci - cm[j0 + jl], x1 = ci - cm[j0 + jl + 1];
                    if (diag && jl > il) x0 = neg_inf();
                    if (diag && jl + 1 > il) x1 = neg_inf();
                    const float e0 = expf(x0), e1 = expf(x1);
                    const int o = w.f(hh, n);
                    const float2 gv = *reinterpret_cast<const float2*>(gt + o);
                    *reinterpret_cast<float2*>(mw + o) =
                        make_float2(gv.x * e0, gv.y * e1);
                    const float d0 = dm[n][2 * hh] * e0;
                    const float d1 = dm[n][2 * hh + 1] * e1;
                    float2* dp = reinterpret_cast<float2*>(dgt + o);
                    const float2 dv = *dp;
                    *dp = make_float2(dv.x + d0, dv.y + d1);
                    const float q0 = d0 * gv.x, q1 = d1 * gv.y;
                    rs[hh] += q0 + q1;
                    if (hh == 0) {
                        cs[n][0] = q0;
                        cs[n][1] = q1;
                    } else {
                        cs[n][0] += q0;
                        cs[n][1] += q1;
                    }
                }
            }
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 1);
                rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 2);
                if (t == 0) red_row[wc * kT + r0 + g + 8 * hh] = rs[hh];
            }
#pragma unroll
            for (int n = 0; n < 4; ++n)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    float v = cs[n][e];
                    v += __shfl_xor_sync(0xffffffffu, v, 4);
                    v += __shfl_xor_sync(0xffffffffu, v, 8);
                    v += __shfl_xor_sync(0xffffffffu, v, 16);
                    if (g == 0) red_col[wr * kT + c0 + 8 * n + 2 * t + e] = v;
                }
            __syncthreads();

            // row sums of this tile pair into rpart; column sums over it
            const long part0 = (long)(bb * H + h0 + h) * nc + ch;
            if (tid < kT) {
                if (i0 + tid < L)
                    rpart[(part0 * nt + jt) * L + i0 + tid] =
                        red_row[tid] + red_row[kT + tid];
            } else if (tid < 2 * kT) {
                const int jl = tid - kT;
                colacc += ((red_col[jl] + red_col[kT + jl]) +
                           red_col[2 * kT + jl]) + red_col[3 * kT + jl];
                if (it == nt - 1) {
                    if (j0 + jl < L) cpart[part0 * L + j0 + jl] = colacc;
                    colacc = 0.f;
                }
            }

            // dX_jt += M^T . dY_it (rows r0.. of j, columns c0.. of p);
            // on the diagonal tile, i < r0 gives M = 0
            zero(part);
            if (c0 < P) {
                const int mb = diag ? r0 / 8 : 0;
                const int me = (min(kT, L - i0) + 7) / 8;
                const float* yb = ys + c0;
                for_steps([&](auto m) {
                    dx_step<decltype(m)::value>(part, mt, yb, ax, w);
                }, mb, me);
            }
            join(dxa, part);
            if (it == nt - 1) {
                store_frags(dx + (hr + j0) * P, P, dxa, r0, c0, L - j0, P,
                            lane);
                zero(dxa);
            }
            __syncthreads();
        }

        // this group's dG band, whole tiles (zero past L), 16-byte stores
        float* out = dgp + ((long)(bb * nc + ch) * ngroups + grp) * ld * ld;
        for (int it = jt; it < nt; ++it) {
            const float* dgt = dband + it * kTile;
            for (int e = tid; e < kTile / 4; e += kBwdThreads) {
                const int r = e / 16, q = (e % 16) * 4;
                *reinterpret_cast<float4*>(
                    out + (long)(it * kT + r) * ld + j0 + q) =
                    *reinterpret_cast<const float4*>(dgt + tix(r, q));
            }
        }
        __syncthreads();
    }
}

// ---------------------------------------------------------------------------
// backward: dB, dC and da
// ---------------------------------------------------------------------------

constexpr int kDbcThreads = 128;        // 4 warps, 16 rows each

template <int M, bool T>
__device__ __forceinline__ void dbc_step(float (&part)[8][4], const float* ds,
                                         const float* vs,
                                         const int (&ax)[2][2],
                                         const Walk& w) {
    Split a[4], b[8][2];
#pragma unroll
    for (int e = 0; e < 4; ++e)
        a[e] = split(T ? ds[ax[e & 1][e >> 1] + 512 * M]
                       : ds[w.r(e & 1, M, e >> 1)]);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int q = 0; q < 2; ++q) b[n][q] = split(vs[w.c(M, n, q)]);
    mma3(part, a, b);
}

// Blocks [0, B nc nt 2 nn): (batch row, chunk, tile, dC or dB, 64 columns
// of N), dGs summed over the ngroups bands in order. dC rows of tile t =
// sum_{jt <= t} dGs(t, jt) . B_jt; dB rows of tile t = sum_{it >= t}
// dGs(it, t)^T . C_it. The blocks after them: da, one warp a (head, chunk)
// row, dcum_k = sum_{jt <= k / 64} rpart[jt][k] - cpart[k], da its reverse
// cumsum within the chunk.
__global__ void __launch_bounds__(kDbcThreads)
ssd_dbc_kernel(const float* __restrict__ b, const float* __restrict__ c,
               const float* __restrict__ dgp, const float* __restrict__ rpart,
               const float* __restrict__ cpart, float* __restrict__ db,
               float* __restrict__ dc, float* __restrict__ da, int B, int H,
               int S, int L, int N, int ngroups, int vbc) {
    __shared__ __align__(16) float ds[kTile];
    __shared__ __align__(16) float vs[kTile];
    const int nt = (L + kT - 1) / kT, nc = S / L, nn = (N + kT - 1) / kT;
    const int ld = nt * kT;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int nblk = B * nc * nt * 2 * nn;
    if ((int)blockIdx.x >= nblk) {
        // da: (head, chunk) rows, one a warp; lane owns a run of up to 8
        const long row = ((long)blockIdx.x - nblk) * 4 + warp;
        if (row >= (long)B * H * nc) return;
        const int per = (L + 31) / 32, k0 = lane * per;
        float loc[8];
        float tot = 0.f;
#pragma unroll
        for (int u = 7; u >= 0; --u) {
            const int k = k0 + u;
            loc[u] = 0.f;
            if (u < per && k < L) {
                float s = 0.f;
                for (int jt = 0; jt <= k / kT; ++jt)
                    s += rpart[(row * nt + jt) * L + k];
                tot += s - cpart[row * L + k];
                loc[u] = tot;
            }
        }
        // the sum over the lanes after this one, in lane order
        float suf = tot;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const float v = __shfl_down_sync(0xffffffffu, suf, off);
            if (lane + off < 32) suf += v;
        }
        float after = __shfl_down_sync(0xffffffffu, suf, 1);
        if (lane == 31) after = 0.f;
        const long bh = row / nc, chh = row % nc;
        float* out = da + bh * S + chh * L;
        for (int u = 0; u < per && k0 + u < L; ++u)
            out[k0 + u] = loc[u] + after;
        return;
    }
    int rest = blockIdx.x;
    const int n0 = (rest % nn) * kT;
    rest /= nn;
    const int which = rest % 2;
    rest /= 2;
    const int tt = rest % nt;
    rest /= nt;
    const int ch = rest % nc, bb = rest / nc;
    const int r0 = 16 * warp;
    const Walk w(lane);
    int ax[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < 2; ++q) ax[h][q] = walk_c(lane, 2 * warp + h, q);
    const long brow = (long)bb * S + (long)ch * L;
    const float* band = dgp + (long)(bb * nc + ch) * ngroups * ld * ld;
    const long gstride = (long)ld * ld;
    float acc[8][4], part[8][4];
    zero(acc);
    const int lo = which == 0 ? 0 : tt, hi = which == 0 ? tt : nt - 1;
    for (int u = lo; u <= hi; ++u) {
        const int i0 = (which == 0 ? tt : u) * kT;
        const int j0 = (which == 0 ? u : tt) * kT;
        const int v0 = u * kT;                    // rows of B or C
        load_tile<kDbcThreads>(vs, (which == 0 ? b : c) + (brow + v0) * N + n0,
                               N, L - v0, N - n0, vbc);
        cp_async_commit();
        // dGs(i0.., j0..): the groups' bands summed in group order, every
        // thread's 8 float4 loads of one group in flight together
        const float* p0 = band + (long)i0 * ld + j0;
        float4 s[8];
#pragma unroll
        for (int v = 0; v < 8; ++v) s[v] = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int gi = 0; gi < ngroups; ++gi) {
            float4 vv[8];
#pragma unroll
            for (int v = 0; v < 8; ++v) {
                const int e = threadIdx.x + v * kDbcThreads;
                vv[v] = *reinterpret_cast<const float4*>(
                    p0 + gi * gstride + (long)(e / 16) * ld + (e % 16) * 4);
            }
#pragma unroll
            for (int v = 0; v < 8; ++v) {
                s[v].x += vv[v].x;
                s[v].y += vv[v].y;
                s[v].z += vv[v].z;
                s[v].w += vv[v].w;
            }
        }
#pragma unroll
        for (int v = 0; v < 8; ++v) {
            const int e = threadIdx.x + v * kDbcThreads;
            *reinterpret_cast<float4*>(ds + tix(e / 16, (e % 16) * 4)) = s[v];
        }
        cp_async_wait<0>();
        __syncthreads();
        zero(part);
        const int nk = (min(kT, L - v0) + 7) / 8;
        if (which == 0) {
            const float* rows = ds + r0 * kT;
            for_steps([&](auto m) {
                dbc_step<decltype(m)::value, false>(part, rows, vs, ax, w);
            }, 0, nk);
        } else {
            for_steps([&](auto m) {
                dbc_step<decltype(m)::value, true>(part, ds, vs, ax, w);
            }, 0, nk);
        }
        join(acc, part);
        __syncthreads();
    }
    const int o0 = tt * kT;
    store_frags((which == 0 ? dc : db) + (brow + o0) * N + n0, N, acc, r0, 0,
                L - o0, N - n0, lane);
}

inline bool aligned16(const void* p) {
    return ((uintptr_t)p & 15) == 0;
}

inline int checked(int B, int H, int S, int L, int P, int N, int hg) {
    if (B <= 0 || H <= 0 || L <= 0 || L > kMaxL || S % L || P <= 0 ||
        P > kMaxP || N <= 0 || hg <= 0 || hg > H || hg > kMaxHeads)
        return (int)cudaErrorInvalidValue;
    return 0;
}

inline int set_smem(const void* fn, long bytes) {
    if (bytes <= 0) return (int)cudaErrorInvalidValue;
    if (bytes <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// dynamic shared memory of one block, bytes; 0 if the shapes are refused
// or it would pass a block's limit
extern "C" long repro_ssd_smem(int backward, int L, int hg) {
    if (L <= 0 || L > kMaxL || hg <= 0) return 0;
    const int nt = (L + kT - 1) / kT, lc = nt * kT + 1;
    const long fixed = backward ? bwd_fixed_floats(nt) : fwd_fixed_floats(nt);
    const long bytes = 4 * (fixed + (long)hg * lc);
    return bytes > kSmemMax ? 0 : bytes;
}

// a (BH, S), x (BH, S, P), b, c (B, S, N), y (BH, S, P), all f32 and
// contiguous, BH = B H, S a multiple of L; hg heads a block
extern "C" int repro_ssd_fwd(const float* a, const float* x, const float* b,
                             const float* c, float* y, int B, int H, int S,
                             int L, int P, int N, int hg, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (int rc = checked(B, H, S, L, P, N, hg)) return rc;
    const int nt = (L + kT - 1) / kT, nc = S / L;
    const long smem = repro_ssd_smem(0, L, hg);
    if (int rc = set_smem((const void*)ssd_fwd_kernel, smem)) return rc;
    const int vx = P % 4 == 0 && aligned16(x);
    const int vbc = N % 4 == 0 && aligned16(b) && aligned16(c);
    ssd_fwd_kernel<<<dim3((nt + 1) / 2, B * nc, (H + hg - 1) / hg),
                     kFwdThreads, smem, st>>>(a, x, b, c, y, H, S, L, P, N,
                                              hg, vx, vbc);
    return (int)cudaGetLastError();
}

// dy (BH, S, P) in; dx (BH, S, P), db, dc (B, S, N), da (BH, S) out.
// Scratch: dgp (B, S / L, ceil(H / hg), 64 nt, 64 nt); rpart (BH, S / L,
// nt, L); cpart (BH, S / L, L); nt = ceil(L / 64).
extern "C" int repro_ssd_bwd(const float* a, const float* x, const float* b,
                             const float* c, const float* dy, float* dx,
                             float* db, float* dc, float* da, float* dgp,
                             float* rpart, float* cpart, int B, int H, int S,
                             int L, int P, int N, int hg, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (int rc = checked(B, H, S, L, P, N, hg)) return rc;
    const int nt = (L + kT - 1) / kT, nc = S / L, nn = (N + kT - 1) / kT;
    const int ngroups = (H + hg - 1) / hg;
    const long smem = repro_ssd_smem(1, L, hg);
    if (int rc = set_smem((const void*)ssd_bwd_kernel, smem)) return rc;
    const int vx = P % 4 == 0 && aligned16(x) && aligned16(dy);
    const int vbc = N % 4 == 0 && aligned16(b) && aligned16(c);
    ssd_bwd_kernel<<<dim3((nt + 1) / 2, B * nc, ngroups), kBwdThreads, smem,
                     st>>>(a, x, b, c, dy, dx, dgp, rpart, cpart, H, S, L, P,
                           N, hg, vx, vbc);
    if (int rc = (int)cudaGetLastError()) return rc;
    const long rows = (long)B * H * nc;
    const long blocks = (long)B * nc * nt * 2 * nn + (rows + 3) / 4;
    ssd_dbc_kernel<<<(unsigned)blocks, kDbcThreads, 0, st>>>(
        b, c, dgp, rpart, cpart, db, dc, da, B, H, S, L, N, ngroups, vbc);
    return (int)cudaGetLastError();
}
