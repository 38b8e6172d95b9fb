// Batched affine-gap Smith-Waterman local alignment on Hopper.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   sw_kernel  <- pepr_tpu/ops/pallas_sw.py::_kernel
//
// What it computes, for every pair b of the batch (the function of
// sw_align_numpy and of the plain sw_align_batch in
// ops/smith_waterman.py), in int32:
//   E(i,j) = max(H(i,j-1) - go, E(i,j-1) - ge)   opening wins ties
//   F(i,j) = max(H(i-1,j) - go, F(i-1,j) - ge)   opening wins ties
//   H(i,j) = max(0, H(i-1,j-1) + sub[q_i][t_j], E(i,j), F(i,j))
// with i over the query and j over the target.  Packed trackers
// (matches << 16 | length) ride along the chosen predecessor: diagonal
// first, then E, then F, and 0 where H <= 0.  The best cell is the one
// with the top score, the smallest query position among those, then
// the smallest target position: each query row keeps its own best by a
// strict > along the target, and a warp reduction takes the first row
// with the top score (the Pallas kernel's per-lane best and final
// argmax).  F is exact, so any gap_open >= 0 and gap_extend >= 0 work.
//
// Only the real cells are walked.  A pair's real lengths are its codes
// less their trailing run of codes that read as PAD (clamp_code maps
// anything outside 0..24 to PAD; the encoders never put PAD inside a
// sequence, and a PAD code inside is walked like any other code).  The
// plain version walks the whole padded rectangle; the two agree on all
// five outputs because:
//   1. Every dependency of the recurrence goes from (i, j) to (i, j+1),
//      (i+1, j) or (i+1, j+1).  The PAD rows and columns lie below and
//      right of every real cell, so no PAD cell feeds a real cell: the
//      real cells' values and trackers are the same either way.
//   2. Order the cells as the best-cell rule does: row first, then
//      column.  Let every score in the PAD row and the PAD column of
//      sub be <= 0, and go, ge >= 0.  A PAD cell's H is 0 or one of
//        d = H(i-1,j-1) + s  <= H(i-1,j-1)        (s <= 0: a PAD code)
//        E(i,j)              <= H(i,k) for some k < j  (E only falls)
//        F(i,j)              <= H(k,j) for some k < i  (F only falls)
//      each the H of a cell earlier in that order.  By induction every
//      PAD cell's H is at most the H of some real cell earlier in the
//      order, or is 0 (which never enters a best: the bests start at 0
//      and move on a strict >).  So no PAD cell is the top score's first
//      cell: where it ties the top score, an earlier real cell holds it.
// The wrapper (ops/sw.py::sw_align) refuses a matrix with a positive
// PAD entry rather than walk the padding.  The kernel also gives PAD
// codes to the rows of its last strip that lie past the real query
// (see below); by 2 they can never win either.
//
// Design.  One warp aligns one pair; the warps of a persistent grid
// take pairs from a counter, in the order given (models/homology.py's
// _bucketed_sw sorts a bucket's pairs by real cells, largest first).  Each lane holds R
// consecutive query rows (R <= MAX_ROWS, the same for every lane of a
// pair) in registers: H and E of the previous column, their trackers,
// and each row's best.  A strip is 32 R rows; a query of lq real rows
// takes n = ceil(lq / (32 MAX_ROWS)) strips of R = ceil(lq / (32 n))
// rows a lane, so the last strip wastes fewer than 32 R rows.  The
// lanes form an anti-diagonal wavefront: at step g lane l works on
// column c = g - l - s P of strip s (P = max(lt, 33)), after the lane
// above it.  At the end of each step a lane hands its bottom row's H, F
// and trackers, and the target code, to the next lane by __shfl_up_sync:
// no block barrier, no shared-memory exchange per step.  Lane 0 takes
// its row above from a per-warp strip buffer in global memory (L2
// resident; __stcg / __ldcg), which the warp fills with the boundary
// row before the walk: lane 31 writes its bottom row there for each
// column, and lane 0 reads it back in the next strip, a step ahead of
// use (P >= 33 keeps the read after the write).  Beside it lie the
// target's codes as table offsets, clamped once per pair.  The strips
// follow each other without a gap, so the wavefront ramps once a pair
// (31 steps), not once a strip.  A step's cells in a lane run top to
// bottom; a row's best moves only on a strict > along the target, and
// rows reach the lane's best in row order, so the tie order of the
// plain version is kept.
//
// What bounds it on this card: int32 operations, about 20 a cell in
// the algorithm (chip_smoke.py's SW_OPS_PER_CELL) and about 26 here
// (the tie order needs explicit compares beside the maxima), plus about
// 40 a step for the hand-over, the strip buffer and the loop, shared
// by a lane's R rows.  Bytes do not bind: the codes, and 32 bytes a
// strip row and column through L2.  DPX does the add-then-max of E and
// F (__viaddmax_s32) and the four-way max of H (__vimax3_s32_relu).  H
// is kept as H - go, from which both E and F open, and the table in
// shared memory holds, per (query code, target code), sub + go and the
// diagonal's tracker increment as one int2: one load and two adds make
// the diagonal and its tracker.  The table is held SUB_COPIES = 16
// times, interleaved; a 64-bit load is served a half-warp at a time, so
// the lanes, reading different entries, never conflict on a bank.

#include <cuda_runtime.h>
#include <stdint.h>

#define WARP 32
#define FULL_MASK 0xFFFFFFFFu
#define N_CODES 25          // codes 0..24; PAD = 24
#define PAD_CODE 24
#define MAX_LEN 4096        // longest query or target
#ifndef MAX_ROWS
#define MAX_ROWS 8          // query rows a lane holds at most
#endif
#define WARPS_PER_BLOCK 8
#ifndef SUB_COPIES
#define SUB_COPIES 16       // copies of the table, one per half-warp lane
#endif
#ifndef MIN_BLOCKS
#define MIN_BLOCKS 2        // resident blocks per SM asked of ptxas
#endif
#define SUB_ENTRIES (N_CODES * N_CODES * SUB_COPIES)
#define SUB_BYTES (SUB_ENTRIES * (int)sizeof(int2))
#define NEG_INF (-(1 << 28))
#define SCRATCH_HEAD 256    // bytes before the strip buffers: the counter

__device__ __forceinline__ int clamp_code(int c) {
    return (c < 0 || c >= N_CODES) ? PAD_CODE : c;
}

// 1 + the index of the last code that does not read as PAD; 0 if none.
__device__ int real_length(const int8_t* __restrict__ s, int L, int lane) {
    for (int base = L - WARP; base > -WARP; base -= WARP) {
        const int x = base + lane;
        const bool real = x >= 0 && clamp_code(s[x]) != PAD_CODE;
        const unsigned m = __ballot_sync(FULL_MASK, real);
        if (m) return base + WARP - __clz(m);
    }
    return 0;
}

__host__ __device__ __forceinline__ int strips_for(int lq) {
    return (lq + WARP * MAX_ROWS - 1) / (WARP * MAX_ROWS);
}

struct Best {
    int v, row, j, ml;
};

// Fold a strip's row bests into the lane's best, rows in order.
template <int R>
__device__ __forceinline__ void fold(Best& b, const int* bv, const int* bml,
                                     const int* bj, int i0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
        if (bv[r] > b.v) {
            b.v = bv[r];
            b.row = i0 + r;
            b.j = bj[r];
            b.ml = bml[r];
        }
    }
}

// The table entry at a shared-memory byte address.
__device__ __forceinline__ int2 table_at(unsigned addr) {
    int2 v;
    asm("ld.shared.v2.s32 {%0, %1}, [%2];" : "=r"(v.x), "=r"(v.y) : "r"(addr));
    return v;
}

// The walk of one pair by one warp, R rows a lane.  H is kept as
// H - go (hg, ag, gg below), the form both E and F open from; the table
// holds sub + go beside each entry's tracker increment, so that the
// diagonal is one add and its tracker another.  buf holds, per column,
// the row above lane 0 (the boundary before strip 0), and tt the target
// code's byte offset in the table.
template <int R>
__device__ __forceinline__ void walk(const int8_t* __restrict__ qb, int lq,
                                     int lt, int n_strips, unsigned tab,
                                     int go, int ge, int4* buf,
                                     const short* tt, int lane, Best& best) {
    const int P = max(lt, WARP + 1);
    const int n_steps = n_strips * P + WARP - 1;
    const unsigned copy = (lane % SUB_COPIES) * sizeof(int2);
    unsigned qaddr[R];                 // the row's table address
    int hg[R], e[R], mlh[R], mle[R];   // H - go, E and trackers at c-1
    int bv[R], bml[R], bj[R];          // the row's best: score, tracker, j
#pragma unroll
    for (int r = 0; r < R; ++r) {
        qaddr[r] = tab;
        mlh[r] = mle[r] = bv[r] = bml[r] = bj[r] = 0;
        hg[r] = -go;
        e[r] = NEG_INF;
    }
    int c = -lane, s = 0;              // this lane's cell at step g
    int dg = -go, dml = 0;             // H - go and tracker of (i0-1, c-1)
    int ug = -go, uf = NEG_INF, umlh = 0, umlf = 0;   // (i0 - 1, c)
    int t_off = 0;
    // lane 0: the inputs of its cell at the next step, loaded a step
    // ahead; pc is that cell's column
    int4 nxt = __ldcg(buf);
    int nxt_t = __ldcg(tt), pc = 0;

    for (int g = 0; g < n_steps; ++g) {
        if (c == 0 && s < n_strips) {  // this lane starts strip s
            if (s > 0)
                fold<R>(best, bv, bml, bj, (s - 1) * WARP * R + lane * R);
            const int i0 = s * WARP * R + lane * R;
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const int i = i0 + r;
                const int code = i < lq ? clamp_code(qb[i]) : PAD_CODE;
                qaddr[r] = tab + code * (N_CODES * SUB_COPIES * sizeof(int2))
                           + copy;
                mlh[r] = mle[r] = bv[r] = bml[r] = bj[r] = 0;
                hg[r] = -go;
                e[r] = NEG_INF;
            }
            dg = -go;
            dml = 0;
        }
        if (lane == 0) {
            ug = nxt.x;
            uf = nxt.y;
            umlh = nxt.z;
            umlf = nxt.w;
            t_off = nxt_t;
            // the cell of step g + 1 reads the column that lane 31 wrote
            // at step g + 32 - P <= g - 1, or the boundary
            if (++pc == P) pc = 0;
            nxt = __ldcg(buf + pc);
            nxt_t = __ldcg(tt + pc);
        }
        // the bottom row, handed on
        int og = -go, of = NEG_INF, oml = 0, omlf = 0;
        if ((unsigned)c < (unsigned)lt && s < n_strips) {
            int ag = ug, af = uf, aml = umlh, amlf = umlf; // above, column c
            int gg = dg, gml = dml;                        // above, column c-1
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const int2 x = table_at(qaddr[r] + t_off);
                const int d = gg + x.x;
                const int mld = gml + x.y;
                // E: gap consuming the target, from (i, c-1)
                const int ev = __viaddmax_s32(e[r], -ge, hg[r]);
                const int mle_v = (ev == hg[r] ? mlh[r] : mle[r]) + 1;
                // F: gap consuming the query, from (i-1, c)
                const int fv = __viaddmax_s32(af, -ge, ag);
                const int mlf_v = (fv == ag ? aml : amlf) + 1;
                const int h = __vimax3_s32_relu(d, ev, fv);
                int ml = h == d ? mld : (h == ev ? mle_v : mlf_v);
                ml = h > 0 ? ml : 0;
                if (h > bv[r]) {
                    bv[r] = h;
                    bml[r] = ml;
                    bj[r] = c;
                }
                gg = hg[r];
                gml = mlh[r];
                hg[r] = h - go;
                e[r] = ev;
                mlh[r] = ml;
                mle[r] = mle_v;
                ag = hg[r];
                af = fv;
                aml = ml;
                amlf = mlf_v;
            }
            dg = ug;
            dml = umlh;
            og = ag;
            of = af;
            oml = aml;
            omlf = amlf;
            if (lane == WARP - 1 && s + 1 < n_strips)
                __stcg(buf + c, make_int4(ag, af, aml, amlf));
        }
        // orders lane 31's buffer store before lane 0's later loads
        __syncwarp();
        ug = __shfl_up_sync(FULL_MASK, og, 1);
        uf = __shfl_up_sync(FULL_MASK, of, 1);
        umlh = __shfl_up_sync(FULL_MASK, oml, 1);
        umlf = __shfl_up_sync(FULL_MASK, omlf, 1);
        t_off = __shfl_up_sync(FULL_MASK, t_off, 1);
        if (++c == P) {
            c = 0;
            ++s;
        }
    }
    fold<R>(best, bv, bml, bj, (n_strips - 1) * WARP * R + lane * R);
}

// walk<rows> for 1 <= rows <= R
template <int R>
__device__ __forceinline__ void walk_rows(int rows, const int8_t* qb, int lq,
                                          int lt, int n_strips, unsigned tab,
                                          int go, int ge, int4* buf,
                                          const short* tt, int lane,
                                          Best& best) {
    if (rows == R)
        walk<R>(qb, lq, lt, n_strips, tab, go, ge, buf, tt, lane, best);
    else if constexpr (R > 1)
        walk_rows<R - 1>(rows, qb, lq, lt, n_strips, tab, go, ge, buf, tt,
                         lane, best);
}

__global__ void __launch_bounds__(WARP * WARPS_PER_BLOCK, MIN_BLOCKS)
sw_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ t,
          const int32_t* __restrict__ sub, int B, int Lq, int Lt, int go,
          int ge, float* __restrict__ score, int32_t* __restrict__ matches,
          int32_t* __restrict__ length, int32_t* __restrict__ q_end,
          int32_t* __restrict__ t_end, int* __restrict__ counter,
          int4* __restrict__ bufs, short* __restrict__ tts, int cols) {
    // [qc][tc][copy]: sub[qc][tc] + go and the tracker increment
    extern __shared__ int2 s_tab[];
    for (int x = threadIdx.x; x < SUB_ENTRIES; x += blockDim.x) {
        const int at = x / SUB_COPIES;
        s_tab[x] = make_int2(sub[at] + go,
                             at / N_CODES == at % N_CODES ? 0x10001 : 1);
    }
    __syncthreads();
    const unsigned tab = (unsigned)__cvta_generic_to_shared(s_tab);

    const int lane = threadIdx.x % WARP;
    const int warp = blockIdx.x * WARPS_PER_BLOCK + threadIdx.x / WARP;
    int4* buf = bufs + (long long)warp * cols;
    short* tt = tts + (long long)warp * cols;
    for (;;) {
        int b = 0;
        if (lane == 0) b = atomicAdd(counter, 1);
        b = __shfl_sync(FULL_MASK, b, 0);
        if (b >= B) break;
        const int8_t* qb = q + (long long)b * Lq;
        const int8_t* tb = t + (long long)b * Lt;
        const int lq = real_length(qb, Lq, lane);
        const int lt = real_length(tb, Lt, lane);
        // no real cell scores above 0: lane 0's row 0 holds the best
        Best best = {0, lane, 0, 0};
        if (lq > 0 && lt > 0) {
            for (int x = lane; x < lt; x += WARP) {
                __stcg(buf + x, make_int4(-go, NEG_INF, 0, 0));
                __stcg(tt + x, (short)(clamp_code(tb[x]) * SUB_COPIES *
                                       (int)sizeof(int2)));
            }
            __syncwarp();
            const int n = strips_for(lq);
            walk_rows<MAX_ROWS>((lq + WARP * n - 1) / (WARP * n), qb, lq, lt,
                                n, tab, go, ge, buf, tt, lane, best);
        }
        // the pair's best: max of (score, -row) as one 64-bit key
        const unsigned long long mine =
            ((unsigned long long)(unsigned)best.v << 32) |
            (0xFFFFFFFFu - (unsigned)best.row);
        unsigned long long key = mine;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const unsigned long long o = __shfl_xor_sync(FULL_MASK, key, off);
            key = o > key ? o : key;
        }
        if (mine == key) {
            score[b] = (float)best.v;
            matches[b] = best.ml >> 16;
            length[b] = best.ml & 0xFFFF;
            q_end[b] = best.row;
            t_end[b] = best.j;
        }
    }
}

static int g_blocks_per_sm = 0, g_sms = 0;

// Resident blocks per SM and SM count, asked once; a CUDA error as a
// negative number.
static int occupancy(void) {
    if (g_blocks_per_sm > 0) return 0;
    cudaError_t err = cudaFuncSetAttribute(
        sw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SUB_BYTES);
    if (err != cudaSuccess) return -(int)err;
    int dev = 0, n = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, sw_kernel, WARP * WARPS_PER_BLOCK,
            SUB_BYTES);
    if (err != cudaSuccess) return -(int)err;
    if (n < 1) return -(int)cudaErrorInvalidConfiguration;
    g_blocks_per_sm = n;
    g_sms = sms;
    return 0;
}

// Columns of a warp's strip buffer: P = max(lt, WARP + 1) at most.
static int buffer_cols(int Lt) { return Lt > WARP + 1 ? Lt : WARP + 1; }

static int grid_blocks(int B) {
    const int want = (B + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
    const int most = g_blocks_per_sm * g_sms;
    return want < most ? want : most;
}

extern "C" {

int sw_max_len(void) { return MAX_LEN; }

int sw_max_rows(void) { return MAX_ROWS; }

// Scratch bytes of a launch: the pair counter, then per warp of the
// grid a strip buffer and the target's table offsets, of buffer_cols(Lt)
// columns each; a negative CUDA error if the card cannot be asked.
long long sw_scratch_bytes(int B, int Lq, int Lt) {
    const int err = occupancy();
    if (err < 0) return err;
    return SCRATCH_HEAD + (long long)grid_blocks(B) * WARPS_PER_BLOCK *
                              buffer_cols(Lt) *
                              (long long)(sizeof(int4) + sizeof(short));
}

// Resident blocks per SM (of WARPS_PER_BLOCK warps), or a negative CUDA
// error.
int sw_blocks_per_sm(void) {
    const int err = occupancy();
    return err < 0 ? err : g_blocks_per_sm;
}

// Registers per thread (cudaFuncGetAttributes), or a negative CUDA
// error.
int sw_num_regs(void) {
    cudaFuncAttributes at;
    cudaError_t err = cudaFuncGetAttributes(&at, sw_kernel);
    return err == cudaSuccess ? at.numRegs : -(int)err;
}

int sw_launch(const void* q, const void* t, const void* sub, int B, int Lq,
              int Lt, int gap_open, int gap_extend, void* score,
              void* matches, void* length, void* q_end, void* t_end,
              void* scratch, long long scratch_bytes, void* stream) {
    if (B < 1 || Lq < 1 || Lt < 1 || Lq > MAX_LEN || Lt > MAX_LEN)
        return (int)cudaErrorInvalidValue;
    const long long need = sw_scratch_bytes(B, Lq, Lt);
    if (need < 0) return (int)-need;
    if (scratch_bytes < need) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(int), s);
    if (err != cudaSuccess) return (int)err;
    const int blocks = grid_blocks(B), cols = buffer_cols(Lt);
    int4* bufs = (int4*)((char*)scratch + SCRATCH_HEAD);
    short* tts = (short*)(bufs + (long long)blocks * WARPS_PER_BLOCK * cols);
    sw_kernel<<<blocks, WARP * WARPS_PER_BLOCK, SUB_BYTES, s>>>(
        (const int8_t*)q, (const int8_t*)t, (const int32_t*)sub, B, Lq, Lt,
        gap_open, gap_extend, (float*)score, (int32_t*)matches,
        (int32_t*)length, (int32_t*)q_end, (int32_t*)t_end, (int*)scratch,
        bufs, tts, cols);
    return (int)cudaGetLastError();
}

const char* sw_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
