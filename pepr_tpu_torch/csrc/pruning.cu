// Felsenstein pruning under WAG+Gamma on Hopper: the per-site
// log-likelihood of a batch of trees over one alignment, and its
// gradient with respect to every edge's transition matrices.
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   pruning_fwd  <- pepr_tpu/ops/pallas_pruning.py::_kernel
//   pruning_bwd  <- pepr_tpu/ops/pallas_pruning_grad.py::_bwd_kernel
//                   (with its _fwd_sweep recompute)
//
// Semantics are those of the Pallas kernels: tips are one-hot over the
// 20 states, ambiguous codes (>= 20 or < 0) are 1 on the live states
// (pi > 1e-6); every postorder internal node multiplies P_child . D_child
// over its 2 (3 at the root) children; one shared per-site rescale
// factor (the max over all categories and states) is taken every 2nd
// internal node and at the root and accumulated in log scale; the site
// log-likelihood is log sum_a pi_a root_a + logscale, then a logsumexp
// over the C equal-weight categories minus log C.  The backward builds
// rescaled upper messages in reverse postorder (a child's upper message
// is rescaled by its parent's forward factor) and sums, per edge, the
// outer products M~_v (x) D~_v * ct_s * exp(logscale - log m_u - lse_s)
// over sites.  The coefficient is formed as ct_s / (m_u sum_c dot_c),
// with dot_c = sum_a pi_a root_a of category c: the same number as
// exp(logscale - log m_u - lse), but without the difference of two
// large logs (|logscale| grows with the number of taxa).
//
// What bounds it on this card: float32 FMAs outside the tensor cores
// (67 TFLOP/s): the 20 x 20 products of every internal edge.  Design:
//
// * A block works on one tree and walks site tiles of TS = 32 * W * R
//   sites (a persistent grid sized to the resident blocks).  W warps
//   hold each category; each lane owns R sites (register blocking), so
//   one warp-uniform float4 of P read from shared memory feeds 4 * R
//   FMAs, and the products run four rows at a time so that 4 * R
//   independent sums hide the FMA latency.
// * Node partials stay on chip.  The wrapper plans, from `children`, a
//   shared-memory slot per internal node by liveness over the postorder
//   (a slot frees once its parent has read it); a node beyond the slots
//   that shared memory holds goes to a global spill tier.  The kernel
//   counts, in one tile of each tree, the partials and upper messages it
//   writes to and reads from global memory in place of a slot.  A partial is stored as computed, with its
//   per-category maxima beside it; its reader takes the shared factor
//   (the max over categories) and scales on read.  A thread only reads
//   the partials it wrote, and the factor is read a node later, so no
//   barrier is spent on rescaling.
// * The three children's matrices (and the ambiguous-tip terms P . live,
//   computed once per launch by a small kernel) of the next node are
//   staged by bulk async copies (the TMA engine, one thread issuing one
//   copy per matrix, completion on an mbarrier) into the other half of a
//   double buffer while the current node computes: one barrier per node.
//   The next node's children and tip codes are read a step ahead.
// * Backward: the forward recompute also writes every partial to a
//   per-block global record (read once more in the reverse sweep); upper
//   messages have their own liveness slots in shared memory (spill tier
//   in global).  Child messages stay in registers, one edge at a time.
//   Per edge and tile, a warp stages M^ (and D for an internal child,
//   which then also serves as the next edge's sibling term) in shared
//   memory and reduces over its sites: a 20 x 20 register-tiled outer
//   product for an internal child; for a leaf no product at all: the
//   warp sorts its sites by code (a counting sort) and adds each code's
//   run of M^ into that column (the live columns for an ambiguous code).
//   Each warp owns a gradient slot that only it updates, in tile order,
//   with coalesced float4 read-modify-writes; a second kernel sums the
//   slots in order, so two launches give bit-identical gradients (no
//   float atomics).

#include <cuda_runtime.h>
#include <stdint.h>

#define NA 20          // states
#define NA2 400        // NA * NA
#define MAXC 4         // Gamma categories a block can hold (W warps each)
#define WARP 32
#define PLAN_W 12      // ints per node in the plan
// The variant built: R sites per lane, W warps per category (8 warps,
// 128 sites per tile).  Timed against other (R, W) and blocks per SM
// on the H100 (pruning_variants.py, which overrides these with -D), it
// was the fastest for both kernels (PERF.md).
#ifndef SITES_PER_LANE
#define SITES_PER_LANE 2
#endif
#ifndef WARPS_PER_CAT
#define WARPS_PER_CAT 2
#endif
#define RESCALE_EVERY 2
#define OFF_CODE (NA + 4)  // code of a site past L: ambiguous

// Plan row of internal node i (written by ops/pruning.py::plan_slots):
//   [0..2]  children (-1 padding)
//   [3]     node's forward slot     [4..6] the children's forward slots
//   [7]     node's upper slot       [8..10] the children's upper slots
// A slot s >= 0 is a shared-memory slot, s < 0 the spill record -s - 1.
enum { PL_KID = 0, PL_FS = 3, PL_KFS = 4, PL_US = 7, PL_KUS = 8 };

struct StepBuf {             // one half of the staging double buffer
    float P[3][MAXC][NA2];   // the children's transition matrices
    float amb[3][MAXC][NA];  // P . live of leaf children
    int plan[PLAN_W];
    unsigned long long bar;  // mbarrier: the bulk copies have landed
    int pad[2];
};

__device__ __forceinline__ bool is_ambiguous(int code) {
    return code < 0 || code >= NA;
}

__device__ __forceinline__ bool rescaled(int i, int n_int) {
    return (i % RESCALE_EVERY == RESCALE_EVERY - 1) || (i == n_int - 1);
}

// Bulk async copies (the TMA engine, no tensor map) completing on an
// mbarrier in shared memory.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
                 "::bytes [%0], [%1], %2, [%3];\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(bytes),
                    "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
    unsigned done = 0;
    do {
        asm volatile("{\n .reg .pred p;\n"
                     " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     " selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(smem_addr(bar)), "r"(parity)
                     : "memory");
    } while (!done);
}

struct Args {
    const int8_t* codes;
    long long codes_bstride;
    const int32_t* plan;   // (B, n_int, PLAN_W)
    const float* pmats;    // (B, C, V, NA, NA)
    const float* amb;      // (B, C, n_leaves, NA)
    const float* pi;       // (NA,)
    const float* ct;       // (B, L), backward
    float* out;            // (B, L), forward
    float* gslot;          // (B, n_chunks, W, C, V, NA, NA), backward
    float* spill;          // forward: spill records per block;
                           // backward: every node's record per block
    float* uspill;         // backward: spilled upper records per block
    int* spills_out;       // (B, 4) spill-tier accesses of one tile:
                           // forward writes, reads; upper writes, reads
    int n_leaves, n_int, L, C;
    int nF, nU;            // shared-memory slots
    int spill_recs, uspill_recs;  // records per block of each tier
};

// Shared-memory layout of a block (floats from the dynamic base).
template <int R, int W>
struct Layout {
    static constexpr int TS = WARP * W * R;          // sites per tile
    static constexpr int REC = MAXC * (NA + 1) * TS; // partials + maxima
    static constexpr int UREC = MAXC * NA * TS;      // upper message
    static constexpr int STRIDE = WARP * R + 4;      // staging row
    static constexpr int BUF = (int)(sizeof(StepBuf) / 4);
    static constexpr int PI = 2 * BUF;
    static constexpr int LIVE = PI + NA;
    static constexpr int RED = LIVE + NA;            // [2][MAXC][TS]
    static constexpr int TALLY = RED + 2 * MAXC * TS;  // int[4]
    static constexpr int SLOTS = TALLY + 4;
    static constexpr int STAGE_W = 2 * NA * STRIDE;  // per warp: M^, D
    __host__ __device__ static long long bytes(int nF, int nU, bool bwd) {
        return 4LL * (SLOTS + (long long)nF * REC + (long long)nU * UREC
                      + (bwd ? MAXC * W * STAGE_W : 0));
    }
};

struct Ctx {
    int b, c, j, lane, tid, nthr, tile;
    bool active;                 // c < C
    int8_t const* codes;         // this tree's codes
    float* sm;                   // dynamic shared memory
    float* fslots;               // forward slots
    float* uslots;               // upper slots (backward)
    float* spill;                // this block's spill (or kept) records
    float* uspill;
    int* tally;                  // spill-tier accesses, or null: counted
                                 // by thread 0 of block 0 in its first tile
};

// Column of this lane's r-th site in a tile record.
template <int R, int W>
__device__ __forceinline__ int col_of(const Ctx& x, int r) {
    return x.j * WARP + x.lane + WARP * W * r;
}

// Children of node i of tree b, from the plan in global memory.
__device__ __forceinline__ void load_kids(const Args& A, int b, int i,
                                          int (&kid)[3]) {
    const int32_t* prow = A.plan + ((size_t)b * A.n_int + i) * PLAN_W;
#pragma unroll
    for (int k = 0; k < 3; ++k) kid[k] = __ldg(prow + PL_KID + k);
}

// Stage step data of node i (children `kid`) into `buf`: one thread
// issues the bulk copies (plan row, the children's matrices and the
// ambiguous-tip terms of leaf children) on the buffer's mbarrier.
__device__ void issue_stage(const Args& A, const Ctx& x, StepBuf* buf,
                            int i, const int (&kid)[3]) {
    if (x.tid != 0) return;
    const int V = A.n_leaves + A.n_int;
    unsigned bytes = PLAN_W * 4;
#pragma unroll
    for (int k = 0; k < 3; ++k)
        if (kid[k] >= 0)
            bytes += A.C * (NA2 + (kid[k] < A.n_leaves ? NA : 0)) * 4;
    // order earlier generic reads of this buffer before the async writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(&buf->bar, bytes);
    bulk_copy(buf->plan, A.plan + ((size_t)x.b * A.n_int + i) * PLAN_W,
              PLAN_W * 4, &buf->bar);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const int v = kid[k];
        if (v < 0) continue;
        for (int cc = 0; cc < A.C; ++cc) {
            bulk_copy(buf->P[k][cc],
                      A.pmats + (((size_t)x.b * A.C + cc) * V + v) * NA2,
                      NA2 * 4, &buf->bar);
            if (v < A.n_leaves)
                bulk_copy(buf->amb[k][cc],
                          A.amb + (((size_t)x.b * A.C + cc) * A.n_leaves + v)
                                      * NA, NA * 4, &buf->bar);
        }
    }
}

// Codes of the leaf children (`kid`) at this lane's sites of `tile`;
// the codes of internal children are not read.
template <int R, int W>
__device__ __forceinline__ void load_codes(const Args& A, const Ctx& x,
                                           const int (&kid)[3], int tile,
                                           int (&code)[3][R]) {
    constexpr int TS = Layout<R, W>::TS;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const int v = kid[k];
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int site = tile * TS + col_of<R, W>(x, r);
            code[k][r] = (v >= 0 && v < A.n_leaves && site < A.L)
                ? (int)__ldg(x.codes + (size_t)v * A.L + site) : OFF_CODE;
        }
    }
}

// Record of internal node `node` with forward slot `fs`: a shared slot,
// or (keep) the node's own global record, or a spill record.
template <int R, int W, bool KEEP>
__device__ __forceinline__ float* frec(const Ctx& x, int node, int fs) {
    if (fs >= 0) return x.fslots + (size_t)fs * Layout<R, W>::REC;
    if (KEEP) return x.spill + (size_t)node * Layout<R, W>::REC;
    return x.spill + (size_t)(-fs - 1) * Layout<R, W>::REC;
}

// The shared factor m of a record (max over categories, floored) for
// this lane's sites.
template <int R, int W>
__device__ __forceinline__ void rec_factor(const Args& A, const Ctx& x,
                                           const float* rec, float* m) {
    constexpr int TS = Layout<R, W>::TS;
    const float* mx = rec + MAXC * NA * TS;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int s = col_of<R, W>(x, r);
        float v = mx[s];
        for (int cc = 1; cc < A.C; ++cc) v = fmaxf(v, mx[cc * TS + s]);
        m[r] = fmaxf(v, 1e-30f);
    }
}

// acc[a][r] *= (P . d)[a] with d[b] = src[b * row + r * rstride] * inv[r]
// (a record column, or the staged D), four rows at a time: 4 * R
// independent sums.
template <int R>
__device__ __forceinline__ void mul_internal_term(
        const float* P, const float* src, int row, int rstride,
        const float* inv, float (&acc)[NA][R]) {
    float d[NA][R];
#pragma unroll
    for (int bb = 0; bb < NA; ++bb)
#pragma unroll
        for (int r = 0; r < R; ++r)
            d[bb][r] = src[bb * row + rstride * r] * inv[r];
#pragma unroll
    for (int a0 = 0; a0 < NA; a0 += 4) {
        float t[4][R];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int r = 0; r < R; ++r) t[u][r] = 0.f;
#pragma unroll
        for (int q = 0; q < NA / 4; ++q) {
            float4 p[4];
#pragma unroll
            for (int u = 0; u < 4; ++u)
                p[u] = reinterpret_cast<const float4*>(P + (a0 + u) * NA)[q];
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    t[u][r] = fmaf(p[u].x, d[4 * q][r], t[u][r]);
                    t[u][r] = fmaf(p[u].y, d[4 * q + 1][r], t[u][r]);
                    t[u][r] = fmaf(p[u].z, d[4 * q + 2][r], t[u][r]);
                    t[u][r] = fmaf(p[u].w, d[4 * q + 3][r], t[u][r]);
                }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int r = 0; r < R; ++r) acc[a0 + u][r] *= t[u][r];
    }
}

// acc[a][r] *= term of child k (P_k . D_k for this category), where D_k
// is a tip (`code`) or the (scaled) record `rec` of an internal child.
template <int R, int W>
__device__ __forceinline__ void mul_child_term(
        const Args& A, const Ctx& x, const StepBuf& sb, int k, int v,
        const int* code, const float* rec, const float* inv,
        float (&acc)[NA][R]) {
    constexpr int TS = Layout<R, W>::TS;
    if (v < A.n_leaves) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const float* col = is_ambiguous(code[r]) ? sb.amb[k][x.c]
                                                     : sb.P[k][x.c] + code[r];
            const int step = is_ambiguous(code[r]) ? 1 : NA;
#pragma unroll
            for (int a = 0; a < NA; ++a) acc[a][r] *= col[a * step];
        }
        return;
    }
    mul_internal_term<R>(sb.P[k][x.c], rec + (size_t)x.c * NA * TS
                             + col_of<R, W>(x, 0), TS, WARP * W, inv, acc);
}

// Scale factors of internal child `node` for this lane's sites: inv (1
// for a node that is not rescaled) and its log, added to logscale.
template <int R, int W>
__device__ __forceinline__ void child_scale(const Args& A, const Ctx& x,
                                            const float* rec, int node,
                                            float* inv, float* logscale) {
    if (rescaled(node, A.n_int)) {
        float m[R];
        rec_factor<R, W>(A, x, rec, m);
#pragma unroll
        for (int r = 0; r < R; ++r) {
            inv[r] = 1.0f / m[r];
            if (logscale) logscale[r] += logf(m[r]);
        }
    } else {
#pragma unroll
        for (int r = 0; r < R; ++r) inv[r] = 1.f;
    }
}

// One forward node: the product of the children's terms, stored with
// its per-category maxima (to the node's slot and, with KEEP, to its
// global record).  At the root (two block barriers): the site LL, and
// lrel = log sum_c dot_c, the site's log-sum-exp less its log scale.
template <int R, int W, bool KEEP>
__device__ void forward_node(const Args& A, const Ctx& x,
                             const StepBuf& sb, int i,
                             const int (&code)[3][R], float* logscale,
                             float* lrel, float* ll) {
    constexpr int TS = Layout<R, W>::TS;
    const bool root = (i == A.n_int - 1);
    float prod[NA][R];
    float mx[R];
    if (x.active) {
#pragma unroll
        for (int a = 0; a < NA; ++a)
#pragma unroll
            for (int r = 0; r < R; ++r) prod[a][r] = 1.f;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            const int v = sb.plan[PL_KID + k];
            if (v < 0) continue;
            const float* rec = nullptr;
            float inv[R];
            if (v >= A.n_leaves) {
                const int node = v - A.n_leaves;
                rec = frec<R, W, KEEP>(x, node, sb.plan[PL_KFS + k]);
                if (x.tally && __isGlobal(rec)) ++x.tally[1];
                child_scale<R, W>(A, x, rec, node, inv, logscale);
            }
            mul_child_term<R, W>(A, x, sb, k, v, code[k], rec, inv, prod);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
            float m = prod[0][r];
#pragma unroll
            for (int a = 1; a < NA; ++a) m = fmaxf(m, prod[a][r]);
            mx[r] = m;
        }
        float* dst[2] = {nullptr, nullptr};
        if (!root) dst[0] = frec<R, W, KEEP>(x, i, sb.plan[PL_FS]);
        if (x.tally && dst[0] && __isGlobal(dst[0])) ++x.tally[0];
        if (KEEP) dst[1] = x.spill + (size_t)i * Layout<R, W>::REC;
        for (int w = 0; w < 2; ++w) {
            if (dst[w] == nullptr || (w == 1 && dst[0] == dst[1])) continue;
            float* p = dst[w] + (size_t)x.c * NA * TS;
#pragma unroll
            for (int a = 0; a < NA; ++a)
#pragma unroll
                for (int r = 0; r < R; ++r)
                    p[a * TS + col_of<R, W>(x, r)] = prod[a][r];
            if (rescaled(i, A.n_int)) {
                float* q = dst[w] + MAXC * NA * TS + x.c * TS;
#pragma unroll
                for (int r = 0; r < R; ++r) q[col_of<R, W>(x, r)] = mx[r];
            }
        }
    }
    if (!root) return;
    // root: shared factor over categories, then the site LL
    float* red = x.sm + Layout<R, W>::RED;
    float* red2 = red + MAXC * TS;
    if (x.active)
#pragma unroll
        for (int r = 0; r < R; ++r) red[x.c * TS + col_of<R, W>(x, r)] = mx[r];
    __syncthreads();
    if (x.active) {
        const float* pi = x.sm + Layout<R, W>::PI;
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int s = col_of<R, W>(x, r);
            float m = red[s];
            for (int cc = 1; cc < A.C; ++cc) m = fmaxf(m, red[cc * TS + s]);
            m = fmaxf(m, 1e-30f);
            const float inv = 1.0f / m;
            logscale[r] += logf(m);
            float dot = 0.f;
#pragma unroll
            for (int a = 0; a < NA; ++a) dot += pi[a] * (prod[a][r] * inv);
            red2[x.c * TS + s] = logf(fmaxf(dot, 1e-30f));
        }
    }
    __syncthreads();
    if (x.active) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int s = col_of<R, W>(x, r);
            float m = red2[s];
            for (int cc = 1; cc < A.C; ++cc) m = fmaxf(m, red2[cc * TS + s]);
            float sum = 0.f;
            for (int cc = 0; cc < A.C; ++cc) sum += expf(red2[cc * TS + s] - m);
            lrel[r] = m + logf(sum);
            ll[r] = (m + logf(sum / (float)A.C)) + logscale[r];
        }
    }
}

template <int R, int W>
__device__ void block_setup(const Args& A, Ctx& x, float* sm, bool bwd) {
    x.b = blockIdx.y;
    x.lane = threadIdx.x & (WARP - 1);
    x.c = threadIdx.x / (WARP * W);
    x.j = (threadIdx.x / WARP) % W;
    x.tid = threadIdx.x;
    x.nthr = blockDim.x;
    x.active = x.c < A.C;
    x.codes = A.codes + (size_t)x.b * A.codes_bstride;
    x.sm = sm;
    x.fslots = sm + Layout<R, W>::SLOTS;
    x.uslots = x.fslots + (size_t)A.nF * Layout<R, W>::REC;
    const size_t blk = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    x.spill = A.spill + blk * (size_t)A.spill_recs * Layout<R, W>::REC;
    x.uspill = bwd
        ? A.uspill + blk * (size_t)A.uspill_recs * Layout<R, W>::UREC
        : nullptr;
    if (x.tid < NA) {
        const float p = A.pi[x.tid];
        sm[Layout<R, W>::PI + x.tid] = p;
        sm[Layout<R, W>::LIVE + x.tid] = p > 1e-6f ? 1.f : 0.f;
    }
    x.tally = nullptr;
    if (blockIdx.x == 0 && x.tid == 0) {
        int* t = reinterpret_cast<int*>(sm + Layout<R, W>::TALLY);
        for (int k = 0; k < 4; ++k) t[k] = 0;
    }
}

// Thread 0 of block 0 counts while it walks its first tile (tile 0);
// at the end it writes the counts out.
template <int R, int W>
__device__ __forceinline__ void set_tally(Ctx& x, int s, int period) {
    x.tally = (blockIdx.x == 0 && x.tid == 0 && s < period)
        ? reinterpret_cast<int*>(x.sm + Layout<R, W>::TALLY) : nullptr;
}

template <int R, int W>
__device__ __forceinline__ void write_tally(const Args& A, const Ctx& x) {
    if (blockIdx.x == 0 && x.tid == 0) {
        const int* t = reinterpret_cast<const int*>(x.sm + Layout<R, W>::TALLY);
        for (int k = 0; k < 4; ++k) A.spills_out[4 * x.b + k] = t[k];
    }
}

// ---------------------------------------------------------------------
// Kernel 0: ambiguous-tip terms amb[b, c, leaf, a] = sum_b P[a][b] live_b.

__global__ void pruning_amb_kernel(const float* __restrict__ pmats,
                                   const float* __restrict__ pi,
                                   float* __restrict__ amb, int B,
                                   int n_leaves, int V, int C) {
    const long long n = (long long)B * C * n_leaves * NA;
    for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         e < n; e += (long long)gridDim.x * blockDim.x) {
        const int a = (int)(e % NA);
        const long long bcl = e / NA;
        const int leaf = (int)(bcl % n_leaves);
        const long long bc = bcl / n_leaves;
        const float* row = pmats + (bc * V + leaf) * NA2 + a * NA;
        float acc = 0.f;
#pragma unroll
        for (int bb = 0; bb < NA; ++bb)
            acc += row[bb] * (pi[bb] > 1e-6f ? 1.f : 0.f);
        amb[e] = acc;
    }
}

// ---------------------------------------------------------------------
// Kernel 1: per-site log-likelihood, out (B, L).

// The steps a block walks: tiles blockIdx.x, + gridDim.x, ... of its
// tree, each `period` steps long; step j of a tile is forward node j, or
// (backward, j >= n_int) reverse node 2 n_int - 1 - j.
struct Steps {
    int n_int, period, n_tiles;
    __device__ bool at(int s, int& tile, int& node) const {
        tile = blockIdx.x + (s / period) * gridDim.x;
        const int j = s % period;
        node = j < n_int ? j : 2 * n_int - 1 - j;
        return tile < n_tiles;
    }
};

// Before step s computes: its matrices are waited for (buffer s % 2,
// used for the (s / 2)-th time: that mbarrier phase); step s + 1's are
// staged, step s + 2's children are read and step s + 1's codes loaded,
// so no dependent global load stands in front of a step's work.
template <int R, int W>
__device__ __forceinline__ void advance(const Args& A, const Ctx& x,
                                        const Steps& seq, StepBuf* buf,
                                        int s, int par, int (&kid1)[3],
                                        int (&ncode)[3][R]) {
    int tile1, node1, tile2, node2;
    const bool has1 = seq.at(s + 1, tile1, node1);
    const bool has2 = seq.at(s + 2, tile2, node2);
    mbar_wait(&buf[par].bar, (s >> 1) & 1);
    __syncthreads();
    if (has1) {
        issue_stage(A, x, &buf[par ^ 1], node1, kid1);
        load_codes<R, W>(A, x, kid1, tile1, ncode);
    }
    if (has2) load_kids(A, x.b, node2, kid1);
}

template <int R, int W>
__global__ void __launch_bounds__(MAXC * W * WARP)
pruning_fwd_kernel(const Args A) {
    extern __shared__ __align__(16) float sm[];
    constexpr int TS = Layout<R, W>::TS;
    Ctx x;
    block_setup<R, W>(A, x, sm, false);
    StepBuf* buf = reinterpret_cast<StepBuf*>(sm);
    const Steps seq{A.n_int, A.n_int, (A.L + TS - 1) / TS};
    int node;
    if (!seq.at(0, x.tile, node)) return;  // uniform over the block
    int kid1[3], code[3][R], ncode[3][R];
    if (x.tid == 0) {
        mbar_init(&buf[0].bar);
        mbar_init(&buf[1].bar);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    load_kids(A, x.b, 0, kid1);
    issue_stage(A, x, &buf[0], 0, kid1);
    load_codes<R, W>(A, x, kid1, x.tile, code);
    if (seq.at(1, x.tile, node)) load_kids(A, x.b, node, kid1);
    float logscale[R], lrel[R], ll[R];
    int par = 0;
    for (int s = 0; seq.at(s, x.tile, node); ++s) {
        advance<R, W>(A, x, seq, buf, s, par, kid1, ncode);
        set_tally<R, W>(x, s, seq.period);
        if (node == 0)
#pragma unroll
            for (int r = 0; r < R; ++r) logscale[r] = 0.f;
        forward_node<R, W, false>(A, x, buf[par], node, code, logscale,
                                  lrel, ll);
        if (node == A.n_int - 1 && x.active && x.c == 0) {
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const int site = x.tile * TS + col_of<R, W>(x, r);
                if (site < A.L) A.out[(size_t)x.b * A.L + site] = ll[r];
            }
        }
#pragma unroll
        for (int k = 0; k < 3; ++k)
#pragma unroll
            for (int r = 0; r < R; ++r) code[k][r] = ncode[k][r];
        par ^= 1;
    }
    write_tally<R, W>(A, x);
}

// ---------------------------------------------------------------------
// Kernel 2: d(sum_s ct_s ll_s)/dP into the warps' gradient slots.

// The gradient of edge (parent -> v) over this warp's sites: the outer
// product of the staged M^ with the staged D (internal v, which leaves D
// staged), or the column add of M^ by code (leaf v, `code` this lane's
// sites' codes).  The 20 x 20 block is formed in shared memory (over
// M^, or for a leaf over D) and added to the warp's slot `g` with
// coalesced float4 loads and stores; the old values are loaded first.
template <int R, int W>
__device__ void edge_grad(const Args& A, const Ctx& x, int v,
                          const int* code, float* Mst, float* Dst,
                          float* g) {
    constexpr int WS = WARP * R;
    constexpr int ST = Layout<R, W>::STRIDE;
    float4* g4 = reinterpret_cast<float4*>(g);
    float4 old[(NA2 / 4 + WARP - 1) / WARP];
#pragma unroll
    for (int q = 0; q * WARP < NA2 / 4; ++q) {
        const int e = x.lane + WARP * q;
        if (e < NA2 / 4) old[q] = g4[e];
    }
    float* Gs = v >= A.n_leaves ? Mst : Dst;  // [NA][NA]
    if (v >= A.n_leaves) {
        // lane = (ab, bb): rows a = ab + 4i, columns b = bb + 5j
        const int ab = x.lane & 3, bb = (x.lane >> 2) < 5 ? x.lane >> 2 : 4;
        float acc[5][4];
#pragma unroll
        for (int i = 0; i < 5; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.f;
        if (x.lane < NA) {
#pragma unroll 4
            for (int s = 0; s < WS; s += 4) {
                float4 m[5], d[4];
#pragma unroll
                for (int i = 0; i < 5; ++i)
                    m[i] = *reinterpret_cast<const float4*>(
                        Mst + (ab + 4 * i) * ST + s);
#pragma unroll
                for (int jj = 0; jj < 4; ++jj)
                    d[jj] = *reinterpret_cast<const float4*>(
                        Dst + (bb + 5 * jj) * ST + s);
#pragma unroll
                for (int i = 0; i < 5; ++i)
#pragma unroll
                    for (int jj = 0; jj < 4; ++jj) {
                        float t = acc[i][jj];
                        t = fmaf(m[i].x, d[jj].x, t);
                        t = fmaf(m[i].y, d[jj].y, t);
                        t = fmaf(m[i].z, d[jj].z, t);
                        acc[i][jj] = fmaf(m[i].w, d[jj].w, t);
                    }
            }
        }
        __syncwarp();
        if (x.lane < NA)
#pragma unroll
            for (int i = 0; i < 5; ++i)
#pragma unroll
                for (int jj = 0; jj < 4; ++jj)
                    Gs[(ab + 4 * i) * NA + bb + 5 * jj] = acc[i][jj];
    } else {
        // leaf: M^[a][s] goes to column col_s (the code, or NA for an
        // ambiguous site, which goes to every live column at the end).
        // The warp sorts its sites by column (a counting sort, in site
        // order within a column), then lane a sums each column's run.
        int* cnt = reinterpret_cast<int*>(Dst + NA2);  // [NA + 1]
        int* sidx = cnt + WARP;                         // [WS] site
        int* scol = sidx + WS;                          // [WS] its column
        const unsigned lt = (1u << x.lane) - 1u;
        int col[R], pos[R];
        if (x.lane <= NA) cnt[x.lane] = 0;
        __syncwarp();
#pragma unroll
        for (int r = 0; r < R; ++r) {
            col[r] = is_ambiguous(code[r]) ? NA : code[r];
            const unsigned same = __match_any_sync(0xffffffffu, col[r]);
            pos[r] = cnt[col[r]] + __popc(same & lt);
            __syncwarp();
            if ((same & lt) == 0) cnt[col[r]] += __popc(same);
            __syncwarp();
        }
        // exclusive scan of the column counts
        const int n = x.lane <= NA ? cnt[x.lane] : 0;
        int incl = n;
#pragma unroll
        for (int o = 1; o < WARP; o <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, incl, o);
            if (x.lane >= o) incl += y;
        }
        __syncwarp();
        if (x.lane <= NA) cnt[x.lane] = incl - n;
        __syncwarp();
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int p = cnt[col[r]] + pos[r];
            sidx[p] = x.lane + WARP * r;
            scol[p] = col[r];
        }
        for (int e = x.lane; e < NA2; e += WARP) Gs[e] = 0.f;
        __syncwarp();
        const int a = x.lane < NA ? x.lane : NA - 1;
        const float* mrow = Mst + a * ST;
        float acc = 0.f, amb = 0.f;
        int c = scol[0];
#pragma unroll 4
        for (int k = 0; k < WS; ++k) {
            acc += mrow[sidx[k]];
            const int cn = k + 1 < WS ? scol[k + 1] : -1;
            if (cn != c) {  // end of column c's run (uniform)
                if (c == NA) amb = acc;
                else if (x.lane < NA) Gs[a * NA + c] = acc;
                acc = 0.f;
                c = cn;
            }
        }
        __syncwarp();
        const float* live = x.sm + Layout<R, W>::LIVE;
        if (x.lane < NA)
#pragma unroll
            for (int bb = 0; bb < NA; ++bb) Gs[a * NA + bb] += live[bb] * amb;
    }
    __syncwarp();
    const float4* G4 = reinterpret_cast<const float4*>(Gs);
#pragma unroll
    for (int q = 0; q * WARP < NA2 / 4; ++q) {
        const int e = x.lane + WARP * q;
        if (e < NA2 / 4) {
            const float4 n = G4[e];
            g4[e] = make_float4(old[q].x + n.x, old[q].y + n.y,
                                old[q].z + n.z, old[q].w + n.w);
        }
    }
}

template <int R, int W>
__device__ void reverse_node(const Args& A, const Ctx& x,
                             const StepBuf& sb, int i,
                             const int (&code)[3][R], const float* lrel,
                             const float* cts, float* g) {
    constexpr int TS = Layout<R, W>::TS;
    constexpr int ST = Layout<R, W>::STRIDE;
    constexpr int REC = Layout<R, W>::REC;
    constexpr int UREC = Layout<R, W>::UREC;
    if (!x.active) return;
    const bool root = (i == A.n_int - 1);
    float coef[R], down[R];
    {
        float lm[R];
        if (rescaled(i, A.n_int)) {
            float m[R];
            rec_factor<R, W>(A, x, x.spill + (size_t)i * REC, m);
#pragma unroll
            for (int r = 0; r < R; ++r) lm[r] = logf(m[r]);
        } else {
#pragma unroll
            for (int r = 0; r < R; ++r) lm[r] = 0.f;
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
            coef[r] = expf(-lm[r] - lrel[r]) * cts[r];
            down[r] = expf(-lm[r]);
        }
    }
    const float* usrc = nullptr;
    if (!root) {
        const int us = sb.plan[PL_US];
        usrc = (us >= 0 ? x.uslots + (size_t)us * UREC
                        : x.uspill + (size_t)(-us - 1) * UREC)
            + (size_t)x.c * NA * TS;
        if (x.tally && __isGlobal(usrc)) ++x.tally[3];
    }
    const float* pi = x.sm + Layout<R, W>::PI;
    float* Mst = x.sm + Layout<R, W>::SLOTS + (size_t)A.nF * REC
        + (size_t)A.nU * UREC
        + (size_t)(x.c * W + x.j) * Layout<R, W>::STAGE_W;
    float* Dst = Mst + NA * ST;
    float ones[R];
#pragma unroll
    for (int r = 0; r < R; ++r) ones[r] = 1.f;
    int staged = -1;  // the child whose scaled D is staged in Dst
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const int v = sb.plan[PL_KID + k];
        if (v < 0) continue;
        // upper message of child k: u times the other children's terms
        float M[NA][R];
#pragma unroll
        for (int a = 0; a < NA; ++a)
#pragma unroll
            for (int r = 0; r < R; ++r)
                M[a][r] = root ? pi[a] : usrc[a * TS + col_of<R, W>(x, r)];
#pragma unroll
        for (int k2 = 0; k2 < 3; ++k2) {
            const int v2 = sb.plan[PL_KID + k2];
            if (k2 == k || v2 < 0) continue;
            if (k2 == staged) {
                mul_internal_term<R>(sb.P[k2][x.c], Dst + x.lane, ST, WARP,
                                     ones, M);
                continue;
            }
            const float* rec = nullptr;
            float inv[R];
            if (v2 >= A.n_leaves) {
                rec = x.spill + (size_t)(v2 - A.n_leaves) * REC;
                child_scale<R, W>(A, x, rec, v2 - A.n_leaves, inv, nullptr);
            }
            mul_child_term<R, W>(A, x, sb, k2, v2, code[k2], rec, inv, M);
        }
        __syncwarp();  // the staged D is read before it is replaced
#pragma unroll
        for (int a = 0; a < NA; ++a)
#pragma unroll
            for (int r = 0; r < R; ++r)
                Mst[a * ST + x.lane + WARP * r] = M[a][r] * coef[r];
        if (v >= A.n_leaves) {
            const int node = v - A.n_leaves;
            const float* rec = x.spill + (size_t)node * REC;
            float inv[R];
            child_scale<R, W>(A, x, rec, node, inv, nullptr);
            const float* src = rec + (size_t)x.c * NA * TS;
#pragma unroll
            for (int bb = 0; bb < NA; ++bb)
#pragma unroll
                for (int r = 0; r < R; ++r)
                    Dst[bb * ST + x.lane + WARP * r] =
                        src[bb * TS + col_of<R, W>(x, r)] * inv[r];
            // push the upper message down, rescaled by the parent's factor
            float acc[NA][R];
#pragma unroll
            for (int bb = 0; bb < NA; ++bb)
#pragma unroll
                for (int r = 0; r < R; ++r) acc[bb][r] = 0.f;
            const float* P = sb.P[k][x.c];
#pragma unroll
            for (int a = 0; a < NA; ++a) {
                const float4* row = reinterpret_cast<const float4*>(P + a * NA);
#pragma unroll
                for (int q = 0; q < NA / 4; ++q) {
                    const float4 p = row[q];
#pragma unroll
                    for (int r = 0; r < R; ++r) {
                        acc[4 * q][r] = fmaf(p.x, M[a][r], acc[4 * q][r]);
                        acc[4 * q + 1][r] = fmaf(p.y, M[a][r], acc[4 * q + 1][r]);
                        acc[4 * q + 2][r] = fmaf(p.z, M[a][r], acc[4 * q + 2][r]);
                        acc[4 * q + 3][r] = fmaf(p.w, M[a][r], acc[4 * q + 3][r]);
                    }
                }
            }
            const int us = sb.plan[PL_KUS + k];
            float* dst = (us >= 0 ? x.uslots + (size_t)us * UREC
                                  : x.uspill + (size_t)(-us - 1) * UREC)
                + (size_t)x.c * NA * TS;
            if (x.tally && __isGlobal(dst)) ++x.tally[2];
#pragma unroll
            for (int bb = 0; bb < NA; ++bb)
#pragma unroll
                for (int r = 0; r < R; ++r)
                    dst[bb * TS + col_of<R, W>(x, r)] = acc[bb][r] * down[r];
        }
        __syncwarp();
        edge_grad<R, W>(A, x, v, code[k], Mst, Dst,
                        g + ((size_t)x.c * (A.n_leaves + A.n_int) + v) * NA2);
        __syncwarp();
        staged = v >= A.n_leaves ? k : -1;
    }
}

template <int R, int W>
__global__ void __launch_bounds__(MAXC * W * WARP)
pruning_bwd_kernel(const Args A) {
    extern __shared__ __align__(16) float sm[];
    constexpr int TS = Layout<R, W>::TS;
    Ctx x;
    block_setup<R, W>(A, x, sm, true);
    StepBuf* buf = reinterpret_cast<StepBuf*>(sm);
    const int V = A.n_leaves + A.n_int;
    const size_t gsize = (size_t)A.C * V * NA2;
    const size_t blk = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    float* gblk = A.gslot + blk * W * gsize;
    for (size_t e = x.tid; e < W * gsize; e += x.nthr) gblk[e] = 0.f;
    float* g = gblk + (size_t)x.j * gsize;
    // steps per tile: the forward, then the reverse sweep
    const Steps seq{A.n_int, 2 * A.n_int, (A.L + TS - 1) / TS};
    int node;
    if (!seq.at(0, x.tile, node)) return;  // uniform over the block
    int kid1[3], code[3][R], ncode[3][R];
    if (x.tid == 0) {
        mbar_init(&buf[0].bar);
        mbar_init(&buf[1].bar);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    load_kids(A, x.b, 0, kid1);
    issue_stage(A, x, &buf[0], 0, kid1);
    load_codes<R, W>(A, x, kid1, x.tile, code);
    if (seq.at(1, x.tile, node)) load_kids(A, x.b, node, kid1);
    float logscale[R], lrel[R], ll[R], cts[R];
    int par = 0;
    for (int s = 0; seq.at(s, x.tile, node); ++s) {
        advance<R, W>(A, x, seq, buf, s, par, kid1, ncode);
        set_tally<R, W>(x, s, seq.period);
        const bool fwd = s % seq.period < A.n_int;
        if (fwd && node == 0) {
#pragma unroll
            for (int r = 0; r < R; ++r) {
                logscale[r] = 0.f;
                const int site = x.tile * TS + col_of<R, W>(x, r);
                cts[r] = site < A.L ? A.ct[(size_t)x.b * A.L + site] : 0.f;
            }
        }
        if (fwd)
            forward_node<R, W, true>(A, x, buf[par], node, code, logscale,
                                     lrel, ll);
        else
            reverse_node<R, W>(A, x, buf[par], node, code, lrel,
                               cts, g);
#pragma unroll
        for (int k = 0; k < 3; ++k)
#pragma unroll
            for (int r = 0; r < R; ++r) code[k][r] = ncode[k][r];
        par ^= 1;
    }
    write_tally<R, W>(A, x);
}

// Kernel 3: grad (B, C, V, NA, NA) = sum over a tree's n_slots slots, in
// slot order.
__global__ void pruning_bwd_reduce_kernel(const float* __restrict__ gslot,
                                          float* __restrict__ grad,
                                          int n_slots, long long per_tree) {
    const int b = blockIdx.y;
    for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         e < per_tree; e += (long long)gridDim.x * blockDim.x) {
        float acc = 0.f;
        for (int k = 0; k < n_slots; ++k)
            acc += gslot[((size_t)b * n_slots + k) * per_tree + e];
        grad[(size_t)b * per_tree + e] = acc;
    }
}

// ---------------------------------------------------------------------
// Host side: the C interface.

using Built = Layout<SITES_PER_LANE, WARPS_PER_CAT>;

static const void* kernel_ptr(int bwd) {
    constexpr int R = SITES_PER_LANE, W = WARPS_PER_CAT;
    return bwd ? (const void*)pruning_bwd_kernel<R, W>
               : (const void*)pruning_fwd_kernel<R, W>;
}

static cudaError_t amb_launch(const void* pmats, const void* pi, void* amb,
                              int B, int n_leaves, int V, int C,
                              cudaStream_t stream) {
    const long long n = (long long)B * C * n_leaves * NA;
    const int threads = 256;
    long long want = (n + threads - 1) / threads;
    const unsigned blocks = (unsigned)(want < 4096 ? want : 4096);
    pruning_amb_kernel<<<blocks, threads, 0, stream>>>(
        (const float*)pmats, (const float*)pi, (float*)amb, B, n_leaves, V,
        C);
    return cudaGetLastError();
}

static cudaError_t main_launch(int bwd, const Args& a, int B, int n_chunks,
                               cudaStream_t stream) {
    const void* fn = kernel_ptr(bwd);
    const long long bytes = Built::bytes(a.nF, a.nU, bwd != 0);
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    dim3 grid(n_chunks, B), block(MAXC * WARPS_PER_CAT * WARP);
    void* params[] = {(void*)&a};
    err = cudaLaunchKernel(fn, grid, block, params, (size_t)bytes, stream);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

extern "C" {

int pruning_warp_sites(void) { return WARP; }

int pruning_max_cats(void) { return MAXC; }

int pruning_plan_width(void) { return PLAN_W; }

int pruning_site_tile(void) { return Built::TS; }

// Shared-memory bytes of a block (kind 0 forward, 1 backward) with nF
// forward and nU upper-message slots.
long long pruning_smem_bytes(int kind, int nF, int nU) {
    return Built::bytes(nF, nU, kind != 0);
}

// Resident blocks per SM of a kernel at that shared-memory size, or a
// negative CUDA error.
int pruning_occupancy(int kind, long long smem) {
    const void* fn = kernel_ptr(kind);
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return -(int)err;
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, fn, MAXC * WARPS_PER_CAT * WARP, (size_t)smem);
    return err == cudaSuccess ? n : -(int)err;
}

// Registers per thread of a kernel (cudaFuncGetAttributes), or a
// negative CUDA error.
int pruning_num_regs(int kind) {
    cudaFuncAttributes at;
    cudaError_t err = cudaFuncGetAttributes(&at, kernel_ptr(kind));
    return err == cudaSuccess ? at.numRegs : -(int)err;
}

int pruning_fwd_launch(const void* codes, long long codes_bstride,
                       const void* plan, const void* pmats, void* amb,
                       const void* pi, void* out, void* spill,
                       void* spills_out, int B, int n_leaves, int n_int,
                       int L, int C, int n_chunks, int nF, int spill_recs,
                       void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = amb_launch(pmats, pi, amb, B, n_leaves,
                                 n_leaves + n_int, C, s);
    if (err != cudaSuccess) return (int)err;
    Args a = {};
    a.codes = (const int8_t*)codes;
    a.codes_bstride = codes_bstride;
    a.plan = (const int32_t*)plan;
    a.pmats = (const float*)pmats;
    a.amb = (const float*)amb;
    a.pi = (const float*)pi;
    a.out = (float*)out;
    a.spill = (float*)spill;
    a.spills_out = (int*)spills_out;
    a.n_leaves = n_leaves;
    a.n_int = n_int;
    a.L = L;
    a.C = C;
    a.nF = nF;
    a.spill_recs = spill_recs;
    return (int)main_launch(0, a, B, n_chunks, s);
}

int pruning_bwd_launch(const void* codes, long long codes_bstride,
                       const void* plan, const void* pmats, void* amb,
                       const void* pi, const void* ct, void* gslot,
                       void* grad, void* keep, void* uspill,
                       void* spills_out, int B, int n_leaves, int n_int,
                       int L, int C, int n_chunks, int nF, int nU,
                       int uspill_recs, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = amb_launch(pmats, pi, amb, B, n_leaves,
                                 n_leaves + n_int, C, s);
    if (err != cudaSuccess) return (int)err;
    Args a = {};
    a.codes = (const int8_t*)codes;
    a.codes_bstride = codes_bstride;
    a.plan = (const int32_t*)plan;
    a.pmats = (const float*)pmats;
    a.amb = (const float*)amb;
    a.pi = (const float*)pi;
    a.ct = (const float*)ct;
    a.gslot = (float*)gslot;
    a.spill = (float*)keep;
    a.uspill = (float*)uspill;
    a.spills_out = (int*)spills_out;
    a.n_leaves = n_leaves;
    a.n_int = n_int;
    a.L = L;
    a.C = C;
    a.nF = nF;
    a.nU = nU;
    a.spill_recs = n_int;
    a.uspill_recs = uspill_recs;
    err = main_launch(1, a, B, n_chunks, s);
    if (err != cudaSuccess) return (int)err;
    const long long per_tree = (long long)C * (n_leaves + n_int) * NA2;
    const int threads = 256;
    long long want = (per_tree + threads - 1) / threads;
    dim3 rgrid((unsigned)(want < 1024 ? want : 1024), B);
    pruning_bwd_reduce_kernel<<<rgrid, threads, 0, s>>>(
        (const float*)gslot, (float*)grad, n_chunks * WARPS_PER_CAT,
        per_tree);
    return (int)cudaGetLastError();
}

const char* pruning_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
