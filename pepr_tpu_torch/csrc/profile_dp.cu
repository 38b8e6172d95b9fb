// Batched profile-profile global alignment (affine Needleman-Wunsch) on
// Hopper: the DP of the progressive MSA.
//
// Not a port of a TPU kernel: the JAX package runs this DP as an XLA
// lax.scan over anti-diagonals (pepr_tpu/ops/profile_align.py:157, in
// nw_profile_batch).  Its plain PyTorch version is ops/profile_align.py's
// step loop (profile_dp_plain), which follows that scan diagonal by
// diagonal; this kernel computes the same function bit for bit.
//
// What it computes, for every pair b of the batch, over its grid cells
// only (rows i = 0..l1, columns j = 0..l2, with l1 = len1[b] and l2 =
// len2[b] clamped to [0, L1] and [0, L2]), in float32:
//   E(i,j) = max(H(i,j-1) - go_e(i), E(i,j-1) - ge_e(i))
//   F(i,j) = max(H(i-1,j) - go_f(j), F(i-1,j) - ge_f(j))
//   M(i,j) = H(i-1,j-1) + s(i-1,j-1)
//   H(i,j) = max(M, max(F, E))
// pointer byte: bits 0-1 the state (0 if H == M, else 1 if H == E, else
// 2), bit 2 set when E's open term >= its extend term, bit 3 the same for
// F.  H(0,0) = 0 once its pointer is made; everything off the grid is NEG
// = -1e30, and M on row 0 or column 0 is NEG + 0 (the plain version pads
// the column scores with zeros there), that is NEG.  E's costs are the
// terminal ones (go_t, ge_t) on rows 0 and l1, F's on columns 0 and l2;
// the caller computes each terminal cost on the host as the float32
// product g * term_scale, as the plain version does.  The score is
// H(l1, l2).  s is the (B, L1, L2) column-score tensor from the same
// torch.matmul / torch.bmm as the plain version's: the kernel does not
// recompute the 20-term dot products, whose summation order would move
// pointer ties.
//
// Bit for bit: the recurrence uses only float32 add, subtract, max and
// compare, and no multiply, so nothing can be contracted into an FMA; the
// library is built without --use_fast_math.  Each value is the same
// IEEE operation on the same operands as in the plain version, and NEG
// absorbs every cost and score (NEG - 11 rounds to NEG), so the values
// fed from off the grid are the plain version's masked NEG exactly.
// Only the grid cells are walked: every dependency goes from (i, j) to
// (i, j+1), (i+1, j) or (i+1, j+1), so no cell past row l1 or column l2
// feeds a grid cell, and the traceback (ops/profile_align.py::traceback)
// reads only grid cells.  The contract is the score and every grid
// pointer; the bytes of the pointer tensor off the grid are not written
// (undefined: the wrapper allocates with torch.empty).
//
// Pointer layout: the traceback's and the plain version's, diagonal-
// major (D, B, L1 + 1) with D = L1 + L2 + 1: the byte of cell (i, j) of
// pair b at ((i + j) B + b)(L1 + 1) + i.  models/msa.py copies it to the
// host and walks it as it comes from either device, so the card and the
// CPU share one traceback and one host path; and the walk below writes
// it in runs: a step's cells lie on one anti-diagonal, so a lane's R
// pointer bytes of a step are consecutive, and the warp's are 32 R
// consecutive bytes.
//
// Design.  A block of W warps aligns one pair (W = min(strips of the
// bucket, MAX_WARPS)).  The l1 + 1 rows take n = ceil((l1 + 1) / (32
// MAX_ROWS)) strips of 32 R rows, R = ceil((l1 + 1) / (32 n)) <=
// MAX_ROWS, so the last strip wastes fewer than 32 R rows; a pair longer
// than one strip runs in more strips and is never refused.  Warp w walks
// strips w, w + W, ...; each lane holds R consecutive rows of its strip
// in registers: each row's H, E and F of its last cell, the H above that
// cell (the next cell's diagonal) and the row's E gap costs.  Row t =
// lane R + r of a strip works at step tau on column c = tau - t: an
// anti-diagonal wavefront over the strip's rows, so the R cells of a
// lane in a step do not depend on each other (each needs only the last
// step's cells) and the warp's cells of a step are one anti-diagonal.
// The rows of a lane run bottom to top, so row r reads row r - 1's cell
// of the last step before it moves on; a row outside the grid at a step
// keeps its registers.  At the end of each step a lane hands its bottom
// row's H and F to the next lane by __shfl_up_sync.  Lane 0 takes its
// row above from the strip before: lane 31 of that strip's warp writes
// its bottom row's (H, F) for each column to a buffer in global memory
// (L2 resident; __stcg / __ldcg) and publishes how many columns are
// there, every PUBLISH columns, in the block's shared memory
// (__threadfence_block, then a volatile store); lane 0 reads a column a
// step ahead of use, waiting on that count when it has caught up.  So
// the strips of a pair run W at a time, each a little over 32 R steps
// behind the one before; above strip 0 lies row -1 (NEG).  Column scores
// come straight from s (row-major, through L1: a row reads each 32-byte
// sector over 8 steps); the lane asks for the sector PREFETCH columns
// ahead for the row that enters one at that step (prefetch.global.L1),
// so that the loads of a later step find it there.  A cell's row and
// column tests are compares on its column and row index, with no loop
// of their own.
//
// What bounds it on this card: bytes.  Each grid cell reads its 4-byte
// column score and writes its 1-byte pointer, 5 bytes, against 13
// float32 operations (E and F two subtractions, a max and a compare
// each, M an add, H two maxima, the state two compares): 5 / 3.35 TB/s
// is about 20 times 13 / 67 TFLOP/s.  This kernel is far from that: it
// runs several instructions a cell for each of the 13 (the row and
// column tests, addresses and moves), a pair runs on one SM, so a batch
// of few long pairs keeps few SMs busy, and a step's loads of its 32 R
// rows touch 32 R different sectors (L1 serves them a lane at a time).
// Pairs over several SMs and column scores staged through shared memory
// are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define WARP 32
#define FULL_MASK 0xFFFFFFFFu
#ifndef MAX_ROWS
#define MAX_ROWS 8          // rows a lane holds at most
#endif
#ifndef MAX_WARPS
#define MAX_WARPS 8         // warps a pair: strips in flight at once
#endif
#define PUBLISH 32          // columns a strip's bottom row is published in
#define PREFETCH 24         // columns ahead a row asks L1 for its scores
#define MAX_STRIPS 8192     // strips a pair at most: the counts' shared memory
#define NEG (-1e30f)
#define STATE_E 1
#define STATE_F 2
#define E_OPEN_BIT 4
#define F_OPEN_BIT 8

struct Costs {
    float go, ge;           // gap open and extend
    float go_t, ge_t;       // the terminal ones: float32(g * term_scale)
};

__host__ __device__ __forceinline__ int strips_for(int rows) {
    return (rows + WARP * MAX_ROWS - 1) / (WARP * MAX_ROWS);
}

// Warps a block: one a strip, up to MAX_WARPS.
static int warps_for(int L1) {
    const int n = strips_for(L1 + 1);
    return n < MAX_WARPS ? n : MAX_WARPS;
}

// A hint to bring the 32-byte sector at p into L1.
__device__ __forceinline__ void prefetch_l1(const float* p) {
    asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

// Wait until at least `need` columns of a strip boundary are published;
// returns the count seen.
__device__ __forceinline__ int wait_columns(volatile int* done, int need) {
    int have;
    while ((have = *done) < need) __nanosleep(20);
    __threadfence_block();  // the buffer's columns after the count
    return have;
}

// The walk of strip s of one pair by one warp, R rows a lane.  sb is the
// pair's (L1, L2) column scores, pb its pointers' base (byte of cell
// (i, j) at pb[(i + j) ds + i]), bufs its strip boundaries (boundary s:
// strip s's bottom row, L2 + 1 (H, F) pairs), done their published
// column counts.
template <int R>
__device__ __forceinline__ void walk(int s, const float* __restrict__ sb,
                                     int L2, int l1, int l2, int n_strips,
                                     const Costs k, float2* bufs,
                                     volatile int* done,
                                     uint8_t* __restrict__ pb, long long ds,
                                     int lane, float* score_b) {
    const int cols = l2 + 1;
    const int i_base = s * WARP * R;
    // the strip's last row on the grid ends its walk at column l2
    const int n_steps = min(WARP * R, l1 + 1 - i_base) - 1 + cols;
    const int i0 = i_base + lane * R;  // the lane's first row
    const int rmax = l1 - i0;          // rows r <= rmax lie on the grid
    const bool feeds = s + 1 < n_strips;
    const float2* bin = bufs + (long long)(s - 1) * (L2 + 1);
    float2* bout = bufs + (long long)s * (L2 + 1);
    float h[R], e[R], f[R], hd[R], goe[R], gee[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        h[r] = e[r] = f[r] = hd[r] = NEG;
        const bool e_term = i0 + r == 0 || i0 + r == l1;
        goe[r] = e_term ? k.go_t : k.go;
        gee[r] = e_term ? k.ge_t : k.ge;
    }
    // lane 0: the row above its row 0's cell of the next step, and the
    // columns of it known to be in the buffer
    float2 nxt = make_float2(NEG, NEG);
    int avail = 0;
    if (lane == 0 && s > 0) {
        avail = wait_columns(done + s - 1, 1);
        nxt = __ldcg(bin);
    }
    float hu = NEG, fu = NEG;  // H and F above row 0's cell
    // s(i0 + r - 1, c - 1) of row r at column c = tau - lane R - r lies
    // at sl + tau + r (L2 - 1); the cell's byte at pl + tau ds + r
    const float* sl = sb + (long long)(i0 - 1) * L2 - lane * R - 1;
    uint8_t* pl = pb + (long long)i_base * ds + i0;

    for (int tau = 0; tau < n_steps; ++tau) {
        const int c0 = tau - lane * R;  // row 0's column
        if (lane == 0) {
            hu = nxt.x;
            fu = nxt.y;
            const int next = tau + 1;
            if (s > 0 && next < cols) {
                if (next >= avail)
                    avail = wait_columns(done + s - 1, next + 1);
                nxt = __ldcg(bin + next);
            }
        }
        const float* st = sl + tau;
        uint8_t* pt = pl + (long long)tau * ds;
        // the row entering a new sector of its scores asks for the one
        // PREFETCH columns ahead
        const int rp = (c0 - 1 + PREFETCH) & 7;
        if (rp < R && rp <= rmax && (unsigned)(c0 - rp - 1 + PREFETCH) <
                                        (unsigned)l2 && (rp > 0 || i0 > 0))
            prefetch_l1(st + (long long)rp * (L2 - 1) + PREFETCH);
#pragma unroll
        for (int r = R - 1; r >= 0; --r) {
            const int c = c0 - r;
            const bool on_row = r <= rmax;
            const bool act = on_row && (unsigned)c < (unsigned)cols;
            // the column score, 0 on row 0 and column 0
            const float sv =
                (on_row && (unsigned)(c - 1) < (unsigned)l2 && (r || i0))
                    ? __ldg(st + (long long)r * (L2 - 1))
                    : 0.0f;
            const float ah = r ? h[r - 1] : hu;  // H(i - 1, c)
            const float af = r ? f[r - 1] : fu;  // F(i - 1, c)
            // F's terminal columns: 0 and l2
            const bool f_term = (unsigned)(c - 1) >= (unsigned)(l2 - 1);
            const float eo = h[r] - goe[r];
            const float ee = e[r] - gee[r];
            const float ev = fmaxf(eo, ee);
            const float fo = ah - (f_term ? k.go_t : k.go);
            const float fe = af - (f_term ? k.ge_t : k.ge);
            const float fv = fmaxf(fo, fe);
            const float m = hd[r] + sv;
            const float hv = fmaxf(m, fmaxf(fv, ev));
            const int state = hv == m ? 0 : (hv == ev ? STATE_E : STATE_F);
            if (act) {
                pt[r] = (uint8_t)(state | (eo >= ee ? E_OPEN_BIT : 0) |
                                  (fo >= fe ? F_OPEN_BIT : 0));
                h[r] = hv;
                e[r] = ev;
                f[r] = fv;
                hd[r] = ah;
            }
        }
        if (i0 == 0 && tau == 0) h[0] = 0.0f;  // the origin, after its pointer
        if ((unsigned)rmax < (unsigned)R && c0 - rmax == l2) {
#pragma unroll
            for (int r = 0; r < R; ++r)
                if (r == rmax) *score_b = h[r];  // H(l1, l2)
        }
        if (feeds && lane == WARP - 1) {  // the bottom row, to the next strip
            const int c = c0 - (R - 1);
            if ((unsigned)c < (unsigned)cols) {
                __stcg(bout + c, make_float2(h[R - 1], f[R - 1]));
                if ((c & (PUBLISH - 1)) == PUBLISH - 1 || c == cols - 1) {
                    __threadfence_block();
                    done[s] = c + 1;
                }
            }
        }
        hu = __shfl_up_sync(FULL_MASK, h[R - 1], 1);
        fu = __shfl_up_sync(FULL_MASK, f[R - 1], 1);
    }
}

// walk<rows> for 1 <= rows <= R
template <int R>
__device__ __forceinline__ void walk_rows(int rows, int s, const float* sb,
                                          int L2, int l1, int l2,
                                          int n_strips, const Costs k,
                                          float2* bufs, volatile int* done,
                                          uint8_t* pb, long long ds, int lane,
                                          float* score_b) {
    if (rows == R)
        walk<R>(s, sb, L2, l1, l2, n_strips, k, bufs, done, pb, ds, lane,
                score_b);
    else if constexpr (R > 1)
        walk_rows<R - 1>(rows, s, sb, L2, l1, l2, n_strips, k, bufs, done,
                         pb, ds, lane, score_b);
}

__global__ void __launch_bounds__(WARP * MAX_WARPS)
profile_dp_kernel(const float* __restrict__ s, const int* __restrict__ len1,
                  const int* __restrict__ len2, int B, int L1, int L2,
                  Costs k, float* __restrict__ score,
                  uint8_t* __restrict__ ptr, float2* __restrict__ bufs) {
    extern __shared__ int done[];  // published columns of each boundary
    const int b = blockIdx.x;
    const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
    const int warps = blockDim.x / WARP;
    const int l1 = min(max(len1[b], 0), L1);
    const int l2 = min(max(len2[b], 0), L2);
    const int n = strips_for(l1 + 1);
    const int R = (l1 + 1 + WARP * n - 1) / (WARP * n);
    for (int x = threadIdx.x; x < n; x += blockDim.x) done[x] = 0;
    __syncthreads();
    const long long R1 = L1 + 1;
    float2* pair_bufs =
        bufs + (long long)b * (strips_for(L1 + 1) - 1) * (L2 + 1);
    for (int st = warp; st < n; st += warps)
        walk_rows<MAX_ROWS>(R, st, s + (long long)b * L1 * L2, L2, l1, l2, n,
                            k, pair_bufs, done, ptr + b * R1,
                            (long long)B * R1, lane, score + b);
}

extern "C" {

int profile_dp_max_rows(void) { return MAX_ROWS; }

int profile_dp_max_warps(void) { return MAX_WARPS; }

// Scratch bytes of a launch: per pair, the boundaries between the
// bucket's strips, L2 + 1 (H, F) pairs each.
long long profile_dp_scratch_bytes(int B, int L1, int L2) {
    const long long n = strips_for(L1 + 1);
    const long long bytes =
        (long long)B * (n - 1) * (L2 + 1) * (long long)sizeof(float2);
    return bytes > 0 ? bytes : 1;
}

// Registers per thread (cudaFuncGetAttributes), or a negative CUDA
// error.
int profile_dp_num_regs(void) {
    cudaFuncAttributes at;
    cudaError_t err = cudaFuncGetAttributes(&at, profile_dp_kernel);
    return err == cudaSuccess ? at.numRegs : -(int)err;
}

// B pairs: s (B, L1, L2) float32 column scores, len1 and len2 (B,) int32,
// the gap costs (go_t and ge_t the terminal ones); writes score (B,)
// float32 and the grid cells of ptr (L1 + L2 + 1, B, L1 + 1) uint8.
// Returns cudaGetLastError() after the launch (0 on success).
int profile_dp_launch(const void* s, const void* len1, const void* len2,
                      int B, int L1, int L2, float go, float ge, float go_t,
                      float ge_t, void* score, void* ptr, void* scratch,
                      long long scratch_bytes, void* stream) {
    if (B < 1 || L1 < 1 || L2 < 1 || strips_for(L1 + 1) > MAX_STRIPS)
        return (int)cudaErrorInvalidValue;
    if (scratch_bytes < profile_dp_scratch_bytes(B, L1, L2))
        return (int)cudaErrorInvalidValue;
    const Costs k = {go, ge, go_t, ge_t};
    profile_dp_kernel<<<B, WARP * warps_for(L1),
                        strips_for(L1 + 1) * sizeof(int),
                        (cudaStream_t)stream>>>(
        (const float*)s, (const int*)len1, (const int*)len2, B, L1, L2, k,
        (float*)score, (uint8_t*)ptr, (float2*)scratch);
    return (int)cudaGetLastError();
}

const char* profile_dp_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
