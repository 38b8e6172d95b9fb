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
// 20 states, ambiguous codes (>= 20) are 1 on the live states
// (pi > 1e-6); every postorder internal node multiplies P_child . D_child
// over its 2 (3 at the root) children; one shared per-site rescale
// factor (the max over all categories and states) is taken every 2nd
// internal node and at the root and accumulated in log scale; the site
// log-likelihood is log sum_a pi_a root_a + logscale, then a logsumexp
// over the C equal-weight categories minus log C.  The backward keeps
// each node's own log factor, builds rescaled upper messages in reverse
// postorder (a child's upper message is rescaled by its parent's
// forward factor) and sums, per edge, the outer products
// M~_v (x) D~_v * ct_s * exp(logscale - log m_u - lse_s) over sites.
//
// Design (simple and right first).  One thread block works on one tree
// of the batch and a strided set of 64-site tiles; its threads are
// (site, category) pairs, 64 x C.  A thread keeps the 20 states of its
// pair in registers.  The 20 x 20 matrices of the children of the
// current node are staged in shared memory, read as warp-wide
// broadcasts.  Leaf children need no product: the term is a column of
// P (or P . live for an ambiguous code).  Internal node partials go to
// a per-block global scratch laid out (node, category, state, site) so
// that reads and writes are coalesced; each thread only ever reads what
// it wrote itself.  The backward reduces the per-edge outer products
// over the tile's sites through shared memory and adds them to a
// gradient slot owned by the block; a second kernel sums the slots in a
// fixed order, so the result is deterministic (no float atomics).
//
// What bounds it on this card: float32 FMAs outside the tensor cores
// (67 TFLOP/s) and the traffic of the node partials through L2/HBM.
// What this design leaves on the table for the later fast version:
// partials resident in shared memory (liveness-based slots instead of
// one scratch row per node), the 20 x 20 products as 3xTF32 or
// split-bf16 tensor-core MMAs (wgmma) over batched site tiles, TMA
// staging of the transition matrices, and a sparse scatter for the
// leaf-edge gradients instead of the dense outer product.

#include <cuda_runtime.h>
#include <stdint.h>

#define NA 20          // states
#define NA2 400        // NA * NA
#define MAXC 4         // Gamma categories a block can hold
#define S_TILE 64      // sites per tile (threads per category)
#define S_PAD (S_TILE + 1)
#define RESCALE_EVERY 2

__device__ __forceinline__ bool is_ambiguous(int code) {
    return code < 0 || code >= NA;
}

// Shared state of one block.
struct Smem {
    float P[3][MAXC][NA][NA];   // transition matrices of the 3 children
    float amb[3][MAXC][NA];     // P . live, the term of an ambiguous tip
    float red[MAXC][S_TILE];    // cross-category reductions per site
    float pi[NA];
    float live[NA];
    int kid[3];
};

// Stage the children of internal node i of tree b (P rows, ambiguous-tip
// terms).  Ends with a barrier; callers must not hold reads of P.
__device__ void stage_node(Smem& sm, const int32_t* children,
                           const float* pmats, int b, int i, int n_int,
                           int n_leaves, int V, int C, int tid, int nthr) {
    __syncthreads();
    if (tid < 3) sm.kid[tid] = children[((size_t)b * n_int + i) * 3 + tid];
    __syncthreads();
    for (int k = 0; k < 3; ++k) {
        const int v = sm.kid[k];
        if (v < 0) continue;
        for (int e = tid; e < C * NA2; e += nthr) {
            const int cc = e / NA2, r = e - cc * NA2;
            (&sm.P[k][cc][0][0])[r] =
                pmats[(((size_t)b * C + cc) * V + v) * NA2 + r];
        }
    }
    __syncthreads();
    for (int e = tid; e < 3 * C * NA; e += nthr) {
        const int k = e / (C * NA), rem = e - k * C * NA;
        const int cc = rem / NA, a = rem - cc * NA;
        const int v = sm.kid[k];
        if (v >= 0 && v < n_leaves) {
            float acc = 0.f;
#pragma unroll
            for (int bb = 0; bb < NA; ++bb)
                acc += sm.P[k][cc][a][bb] * sm.live[bb];
            sm.amb[k][cc][a] = acc;
        }
    }
    __syncthreads();
}

// term[a] = sum_b P[a][b] d[b] for the thread's category, with P in
// shared memory (warp-uniform rows: broadcast reads).
__device__ __forceinline__ void matvec(const float (*P)[NA],
                                       const float* d, float* term) {
#pragma unroll
    for (int a = 0; a < NA; ++a) {
        const float4* row = reinterpret_cast<const float4*>(P[a]);
        float acc = 0.f;
#pragma unroll
        for (int q = 0; q < NA / 4; ++q) {
            const float4 p = row[q];
            acc += p.x * d[4 * q] + p.y * d[4 * q + 1]
                 + p.z * d[4 * q + 2] + p.w * d[4 * q + 3];
        }
        term[a] = acc;
    }
}

struct TileCtx {
    int b, s, c, tid, nthr, site;
    bool valid;
    size_t scr_node;    // stride of one node in the scratch
    float* scr;         // this block's partials, (n_int, C, NA, S_TILE)
    const int8_t* codes;  // this tree's codes, (n_leaves, L)
    int L;
};

__device__ __forceinline__ size_t node_off(const TileCtx& t, int node,
                                           int a) {
    return (size_t)node * t.scr_node + ((size_t)t.c * NA + a) * S_TILE
        + t.s;
}

__device__ __forceinline__ int tip_code(const TileCtx& t, int leaf) {
    return t.valid ? (int)t.codes[(size_t)leaf * t.L + t.site] : NA + 4;
}

// The term P_k . D_k of child slot k for this thread.
__device__ __forceinline__ void child_term(const Smem& sm, const TileCtx& t,
                                           int k, int n_leaves,
                                           float* term) {
    const int v = sm.kid[k];
    if (v < n_leaves) {
        const int code = tip_code(t, v);
        if (is_ambiguous(code)) {
#pragma unroll
            for (int a = 0; a < NA; ++a) term[a] = sm.amb[k][t.c][a];
        } else {
#pragma unroll
            for (int a = 0; a < NA; ++a) term[a] = sm.P[k][t.c][a][code];
        }
    } else {
        float d[NA];
        const int node = v - n_leaves;
#pragma unroll
        for (int bb = 0; bb < NA; ++bb) d[bb] = t.scr[node_off(t, node, bb)];
        matvec(sm.P[k][t.c], d, term);
    }
}

// Forward sweep over one tile: stores every internal node's (rescaled)
// partials, optionally each node's log factor, and returns the root's
// rescaled partials in `root` and the site's log scale.
__device__ void forward_sweep(Smem& sm, const TileCtx& t,
                              const int32_t* children, const float* pmats,
                              int n_leaves, int n_int, int V, int C,
                              float* logm, float* root, float& logscale) {
    logscale = 0.f;
    for (int i = 0; i < n_int; ++i) {
        stage_node(sm, children, pmats, t.b, i, n_int, n_leaves, V, C,
                   t.tid, t.nthr);
        float prod[NA];
#pragma unroll
        for (int a = 0; a < NA; ++a) prod[a] = 1.f;
        for (int k = 0; k < 3; ++k) {
            if (sm.kid[k] < 0) continue;
            float term[NA];
            child_term(sm, t, k, n_leaves, term);
#pragma unroll
            for (int a = 0; a < NA; ++a) prod[a] *= term[a];
        }
        const bool resc = (i % RESCALE_EVERY == RESCALE_EVERY - 1)
            || (i == n_int - 1);
        float lm = 0.f;
        if (resc) {
            float mx = prod[0];
#pragma unroll
            for (int a = 1; a < NA; ++a) mx = fmaxf(mx, prod[a]);
            sm.red[t.c][t.s] = mx;
            __syncthreads();
            float m = sm.red[0][t.s];
            for (int cc = 1; cc < C; ++cc) m = fmaxf(m, sm.red[cc][t.s]);
            m = fmaxf(m, 1e-30f);
            lm = logf(m);
            logscale += lm;
            const float inv = 1.0f / m;
#pragma unroll
            for (int a = 0; a < NA; ++a) prod[a] *= inv;
        }
        if (logm != nullptr)
            logm[((size_t)i * MAXC + t.c) * S_TILE + t.s] = lm;
        if (i == n_int - 1) {
#pragma unroll
            for (int a = 0; a < NA; ++a) root[a] = prod[a];
        }
#pragma unroll
        for (int a = 0; a < NA; ++a) t.scr[node_off(t, i, a)] = prod[a];
    }
}

// Per-site log-likelihood at the root: returns ll and writes lse
// (= ll + log C).  Contains barriers.
__device__ float root_ll(Smem& sm, const TileCtx& t, const float* root,
                         float logscale, int C, float& lse) {
    float dot = 0.f;
#pragma unroll
    for (int a = 0; a < NA; ++a) dot += sm.pi[a] * root[a];
    const float site_cat = logf(fmaxf(dot, 1e-30f)) + logscale;
    __syncthreads();
    sm.red[t.c][t.s] = site_cat;
    __syncthreads();
    float mx = sm.red[0][t.s];
    for (int cc = 1; cc < C; ++cc) mx = fmaxf(mx, sm.red[cc][t.s]);
    float sum = 0.f;
    for (int cc = 0; cc < C; ++cc) sum += expf(sm.red[cc][t.s] - mx);
    lse = mx + logf(sum);
    return mx + logf(sum / (float)C);
}

__device__ void load_shared_model(Smem& sm, const float* pi, int tid) {
    if (tid < NA) {
        sm.pi[tid] = pi[tid];
        sm.live[tid] = pi[tid] > 1e-6f ? 1.f : 0.f;
    }
    __syncthreads();
}

// ---------------------------------------------------------------------
// Kernel 1: per-site log-likelihood, out (B, L).

__global__ void __launch_bounds__(S_TILE * MAXC)
pruning_fwd_kernel(const int8_t* __restrict__ codes, long long codes_bstride,
                   const int32_t* __restrict__ children,
                   const float* __restrict__ pmats,
                   const float* __restrict__ pi, float* __restrict__ out,
                   float* __restrict__ scratch, int n_leaves, int n_int,
                   int L, int C) {
    __shared__ __align__(16) Smem sm;
    TileCtx t;
    t.b = blockIdx.y;
    t.s = threadIdx.x;
    t.c = threadIdx.y;
    t.nthr = S_TILE * C;
    t.tid = t.c * S_TILE + t.s;
    t.L = L;
    t.codes = codes + (size_t)t.b * codes_bstride;
    t.scr_node = (size_t)C * NA * S_TILE;
    const size_t blk = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    t.scr = scratch + blk * n_int * t.scr_node;
    const int V = n_leaves + n_int;
    const int n_tiles = (L + S_TILE - 1) / S_TILE;
    load_shared_model(sm, pi, t.tid);
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        t.site = tile * S_TILE + t.s;
        t.valid = t.site < L;
        float root[NA], logscale, lse;
        forward_sweep(sm, t, children, pmats, n_leaves, n_int, V, C,
                      nullptr, root, logscale);
        const float ll = root_ll(sm, t, root, logscale, C, lse);
        if (t.c == 0 && t.valid) out[(size_t)t.b * L + t.site] = ll;
    }
}

// ---------------------------------------------------------------------
// Kernel 2: d(sum_s ct_s ll_s)/dP, one slot per block:
// gslot (B, n_chunks, C, V, NA, NA); reduced by kernel 3.

struct BwdSmem {  // dynamic shared memory (with Smem, above 48 KB)
    float M[MAXC][NA][S_PAD];   // scaled upper messages of the edge
    float D[MAXC][NA][S_PAD];   // lower partials of the edge's child
};

__global__ void __launch_bounds__(S_TILE * MAXC)
pruning_bwd_kernel(const int8_t* __restrict__ codes, long long codes_bstride,
                   const int32_t* __restrict__ children,
                   const float* __restrict__ pmats,
                   const float* __restrict__ pi,
                   const float* __restrict__ ct, float* __restrict__ gslot,
                   float* __restrict__ scratch, int n_leaves, int n_int,
                   int L, int C) {
    __shared__ __align__(16) Smem sm;
    extern __shared__ __align__(16) unsigned char dyn_smem[];
    BwdSmem& bs = *reinterpret_cast<BwdSmem*>(dyn_smem);
    TileCtx t;
    t.b = blockIdx.y;
    t.s = threadIdx.x;
    t.c = threadIdx.y;
    t.nthr = S_TILE * C;
    t.tid = t.c * S_TILE + t.s;
    t.L = L;
    t.codes = codes + (size_t)t.b * codes_bstride;
    t.scr_node = (size_t)C * NA * S_TILE;
    const int V = n_leaves + n_int;
    const size_t blk = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    // per-block scratch: partials | upper messages | child terms | logm
    float* base = scratch + blk * ((size_t)(2 * n_int + 3) * t.scr_node
                                   + (size_t)n_int * MAXC * S_TILE);
    t.scr = base;
    float* upper = base + (size_t)n_int * t.scr_node;
    float* tmsg = upper + (size_t)n_int * t.scr_node;
    float* logm = tmsg + (size_t)3 * t.scr_node;
    const size_t gsize = (size_t)C * V * NA2;
    float* g = gslot + blk * gsize;
    for (size_t e = t.tid; e < gsize; e += t.nthr) g[e] = 0.f;

    const int n_tiles = (L + S_TILE - 1) / S_TILE;
    load_shared_model(sm, pi, t.tid);
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        t.site = tile * S_TILE + t.s;
        t.valid = t.site < L;
        float root[NA], logscale, lse;
        forward_sweep(sm, t, children, pmats, n_leaves, n_int, V, C,
                      logm, root, logscale);
        root_ll(sm, t, root, logscale, C, lse);
        const float cts = t.valid ? ct[(size_t)t.b * L + t.site] : 0.f;

        for (int i = n_int - 1; i >= 0; --i) {  // parents before children
            stage_node(sm, children, pmats, t.b, i, n_int, n_leaves, V, C,
                       t.tid, t.nthr);
            const float lm_i = logm[((size_t)i * MAXC + t.c) * S_TILE + t.s];
            float u[NA];
            if (i == n_int - 1) {
#pragma unroll
                for (int a = 0; a < NA; ++a) u[a] = sm.pi[a];
            } else {
#pragma unroll
                for (int a = 0; a < NA; ++a) u[a] = upper[node_off(t, i, a)];
            }
            const float coef = expf(logscale - lm_i - lse) * cts;
            const float down = expf(-lm_i);
            // child messages T_k = P_k . D~_k, kept in scratch
            for (int k = 0; k < 3; ++k) {
                if (sm.kid[k] < 0) continue;
                float term[NA];
                child_term(sm, t, k, n_leaves, term);
#pragma unroll
                for (int a = 0; a < NA; ++a)
                    tmsg[((size_t)k * C + t.c) * NA * S_TILE
                         + (size_t)a * S_TILE + t.s] = term[a];
            }
            for (int k = 0; k < 3; ++k) {
                const int v = sm.kid[k];
                if (v < 0) continue;
                // upper message of child k: u times the other siblings
                float mv[NA];
#pragma unroll
                for (int a = 0; a < NA; ++a) mv[a] = u[a];
                for (int k2 = 0; k2 < 3; ++k2) {
                    if (k2 == k || sm.kid[k2] < 0) continue;
#pragma unroll
                    for (int a = 0; a < NA; ++a)
                        mv[a] *= tmsg[((size_t)k2 * C + t.c) * NA * S_TILE
                                      + (size_t)a * S_TILE + t.s];
                }
                // stage M^ and D~ of this edge for the site reduction
#pragma unroll
                for (int a = 0; a < NA; ++a) bs.M[t.c][a][t.s] = mv[a] * coef;
                if (v < n_leaves) {
                    const int code = tip_code(t, v);
                    const bool amb = is_ambiguous(code);
#pragma unroll
                    for (int bb = 0; bb < NA; ++bb)
                        bs.D[t.c][bb][t.s] = amb ? sm.live[bb]
                                                 : (bb == code ? 1.f : 0.f);
                } else {
#pragma unroll
                    for (int bb = 0; bb < NA; ++bb)
                        bs.D[t.c][bb][t.s] =
                            t.scr[node_off(t, v - n_leaves, bb)];
                }
                // push the upper message down, rescaled by m_u
                if (v >= n_leaves) {
                    const int node = v - n_leaves;
#pragma unroll
                    for (int bb = 0; bb < NA; ++bb) {
                        float acc = 0.f;
#pragma unroll
                        for (int a = 0; a < NA; ++a)
                            acc += sm.P[k][t.c][a][bb] * mv[a];
                        upper[node_off(t, node, bb)] = acc * down;
                    }
                }
                __syncthreads();
                for (int o = t.tid; o < C * NA2; o += t.nthr) {
                    const int cc = o / NA2, r = o - cc * NA2;
                    const int a = r / NA, bb = r - a * NA;
                    const float* mrow = bs.M[cc][a];
                    const float* drow = bs.D[cc][bb];
                    float acc = 0.f;
#pragma unroll 8
                    for (int q = 0; q < S_TILE; ++q) acc += mrow[q] * drow[q];
                    g[((size_t)cc * V + v) * NA2 + r] += acc;
                }
                __syncthreads();
            }
        }
    }
}

// Kernel 3: grad (B, C, V, NA, NA) = sum over chunks of the slots, in
// chunk order.
__global__ void pruning_bwd_reduce_kernel(const float* __restrict__ gslot,
                                          float* __restrict__ grad,
                                          int n_chunks, long long per_tree) {
    const int b = blockIdx.y;
    for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         e < per_tree; e += (long long)gridDim.x * blockDim.x) {
        float acc = 0.f;
        for (int k = 0; k < n_chunks; ++k)
            acc += gslot[((size_t)b * n_chunks + k) * per_tree + e];
        grad[(size_t)b * per_tree + e] = acc;
    }
}

// ---------------------------------------------------------------------
// C interface.  Pointers are device pointers; the stream is PyTorch's
// current stream.  Each launcher returns cudaGetLastError().

extern "C" {

long long pruning_fwd_scratch_floats(int n_int, int C, int n_blocks) {
    return (long long)n_blocks * n_int * C * NA * S_TILE;
}

long long pruning_bwd_scratch_floats(int n_int, int C, int n_blocks) {
    return (long long)n_blocks * ((long long)(2 * n_int + 3) * C * NA * S_TILE
                                  + (long long)n_int * MAXC * S_TILE);
}

int pruning_site_tile(void) { return S_TILE; }

int pruning_max_cats(void) { return MAXC; }

int pruning_fwd_launch(const void* codes, long long codes_bstride,
                       const void* children, const void* pmats,
                       const void* pi, void* out, void* scratch, int B,
                       int n_leaves, int n_int, int L, int C, int n_chunks,
                       void* stream) {
    dim3 grid(n_chunks, B), block(S_TILE, C);
    pruning_fwd_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const int8_t*)codes, codes_bstride, (const int32_t*)children,
        (const float*)pmats, (const float*)pi, (float*)out,
        (float*)scratch, n_leaves, n_int, L, C);
    return (int)cudaGetLastError();
}

int pruning_bwd_launch(const void* codes, long long codes_bstride,
                       const void* children, const void* pmats,
                       const void* pi, const void* ct, void* gslot,
                       void* grad, void* scratch, int B, int n_leaves,
                       int n_int, int L, int C, int n_chunks, void* stream) {
    dim3 grid(n_chunks, B), block(S_TILE, C);
    cudaError_t err = cudaFuncSetAttribute(
        pruning_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)sizeof(BwdSmem));
    if (err != cudaSuccess) return (int)err;
    pruning_bwd_kernel<<<grid, block, sizeof(BwdSmem),
                         (cudaStream_t)stream>>>(
        (const int8_t*)codes, codes_bstride, (const int32_t*)children,
        (const float*)pmats, (const float*)pi, (const float*)ct,
        (float*)gslot, (float*)scratch, n_leaves, n_int, L, C);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long per_tree = (long long)C * (n_leaves + n_int) * NA2;
    const int threads = 256;
    long long want = (per_tree + threads - 1) / threads;
    dim3 rgrid((unsigned)(want < 1024 ? want : 1024), B);
    pruning_bwd_reduce_kernel<<<rgrid, threads, 0, (cudaStream_t)stream>>>(
        (const float*)gslot, (float*)grad, n_chunks, per_tree);
    return (int)cudaGetLastError();
}

const char* pruning_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
