// Batched profile-profile global alignment (affine Needleman-Wunsch) on
// Hopper: the DP of the progressive MSA and its traceback, one launch.
//
// Not a port of a TPU kernel: the JAX package runs this DP as an XLA
// lax.scan over anti-diagonals (pepr_tpu/ops/profile_align.py:157, in
// nw_profile_batch) and walks its pointers on the host.  Its plain
// PyTorch version is ops/profile_align.py's step loop (profile_dp_plain)
// followed by the host walk (traceback); this kernel computes the same
// function bit for bit.
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
// feeds a grid cell, and the traceback reads only grid cells.  The
// contract is the score, every grid pointer and the path; the bytes of
// the pointer tensor off the grid are not written (undefined: the
// wrapper allocates with torch.empty).
//
// Outputs.  The pointers stay diagonal-major (D, B, L1 + 1) with D = L1 +
// L2 + 1, the plain version's layout: the byte of cell (i, j) of pair b at
// ((i + j) B + b)(L1 + 1) + i; a step's cells lie on one anti-diagonal,
// so a warp's pointer bytes of a step are consecutive.  The path is what
// the caller needs: once all strips of a pair are done, the block walks
// the pointers it just wrote from (l1, l2) back to (0, 0) with exactly
// the rules of ops/profile_align.py::traceback (the start state from
// cell (l1, l2), the row-0 and column-0 shortcuts, the open bits ending
// an E or F run) and writes one byte a move, bit 0 set when the move
// consumes a column of profile 1 and bit 1 when it consumes one of
// profile 2 (3 diagonal, 2 a gap in profile 1, 1 a gap in profile 2),
// from the end of the pair's row of path (B, L1 + L2) backward: the
// moves lie in forward order in path[b, L1 + L2 - n : L1 + L2], n =
// path_len[b].  The walk reads a window of WIN_DIAGS diagonals by
// WIN_ROWS rows around its cell, which the whole block loads into shared
// memory (a warp a diagonal's 32 consecutive bytes) and tabulates (for
// each cell, the state after a move out of it in each of the three
// states); one thread then walks it, a table byte a move, until its next
// move would leave it (at least WIN_ROWS - 1 moves a window).  So
// models/msa.py copies B (L1 + L2) path bytes to the host, not the
// pointers.
//
// Design.  Two kernels, one launch a call either way.  A block of W
// warps aligns one pair; each lane of a warp holds R consecutive rows of
// the warp's strip of 32 R rows in registers: each row's H, E and F of
// its last cell, the H above that cell (the next cell's diagonal) and
// the row's E gap costs.  Row t = lane R + r of a strip works at step
// tau on column c = tau - t: an anti-diagonal wavefront over the strip's
// rows, so the R cells of a lane in a step do not depend on each other
// and the warp's cells of a step are one anti-diagonal.  The rows of a
// lane run bottom to top, so row r reads row r - 1's cell of the last
// step before it moves on; a row outside the grid at a step keeps its
// registers.  At the end of each step a lane hands its bottom row's H
// and F to the next lane by __shfl_up_sync; lane 0 takes its row above
// from the strip before (row -1, NEG, above strip 0), a column a step
// ahead of use, and lane 31 of that strip's warp hands on its bottom
// row, a column a step.
//  - The shared kernel, for the buckets whose longest pair has at most
//    SHARED_ROWS rows (L1 < 2,048 by default): W is the most warps, up
//    to ceil((L1 + 1) / 32) and SHARED_WARPS, at which every block of
//    the call is resident at once (plan_for asks the occupancy
//    calculator; on an H100, 16 warps a pair for 32 pairs at 1,024, 4
//    for the 405 of a merge wave at 256), and a pair's rows are spread
//    over them (R = ceil((l1 + 1) / (32 W)), n = ceil((l1 + 1) / (32 R))
//    <= W strips, all in flight, a warp each).  A boundary goes through a ring of
//    RING_SLOTS slots of RING_COLS (H, F) columns in shared memory, each
//    slot with a full and an empty mbarrier (lane 31 arrives on full when
//    it has written a slot, lane 0 on empty when it has read one; each
//    waits on the other's barrier's phase before it writes or reads the
//    slot again), so each strip runs about RING_COLS + 32 R steps behind
//    the one before.  When the bucket's rows fit at most STAGE_ROWS a
//    lane, a warp stages its strip's column scores in shared memory with
//    cp.async: a window of STAGE_COLS columns a row (row t of the strip
//    at physical row (t % R) 32 + t / R, row stride 32 or 33 floats so
//    that a step's reads, one anti-diagonal, and an epoch's copies hit
//    32 banks), filled EPOCH columns at a time two epochs ahead (each
//    step every lane copies R scores, 4 rows x EPOCH columns a warp
//    instruction: 32-byte runs of a row); a step reads its 32 R scores
//    from shared memory.
//  - The global kernel, for longer buckets: W = min(strips, MAX_WARPS)
//    with the fewest strips, n = ceil((l1 + 1) / (32 MAX_ROWS)), of as
//    many rows as balance them; warp w walks strips w, w + W, ..., so a
//    bounded ring cannot serve (warp W - 1 would wait on warp 0, still
//    walking its first strip): a boundary goes through a buffer of L2 +
//    1 columns in global memory (L2 resident; __stcg / __ldcg) whose
//    published count lives in shared memory (every PUBLISH columns; lane
//    0 polls it with __nanosleep when it has caught up).  The scores come
//    straight from s (row-major, through L1), the lane asking for the
//    sector PREFETCH columns ahead for the row that enters one
//    (prefetch.global.L1).  Its own instantiation keeps its registers
//    (99 against 80 when the ring's code shared the kernel, which took
//    twice the time at 8 x 8,192^2 on an H100).
//
// What bounds it on this card: bytes.  Each grid cell reads its 4-byte
// column score and writes its 1-byte pointer, 5 bytes, against 13
// float32 operations (E and F two subtractions, a max and a compare
// each, M an add, H two maxima, the state two compares): 5 / 3.35 TB/s
// is about 20 times 13 / 67 TFLOP/s; the walk adds a byte read and a byte
// written a move.  The kernel is far from that: it runs several
// instructions a cell for each of the 13 (the row and column tests,
// addresses and moves), one strip's wavefront is a chain of l1 + l2
// dependent steps, the walk a chain of l1 + l2 dependent moves, and a
// pair runs on one SM, so a batch of few long pairs keeps few SMs busy.
// Pairs over several SMs (thread-block clusters, the boundary in
// distributed shared memory) are later work.
//
// Measurement builds: -DSTAMP records clock64() at each step of block 0's
// first strip and at the DP's and the walk's ends (profile_dp_stamps
// reads them); -DABLATE=mask drops work for a measurement only (1 the
// score loads, 2 the pointer stores, 4 the boundary hand-over, 8 the
// walk): its results are wrong.  -DSHARED_ROWS=0 builds the global
// kernel alone (the first design), -DSTAGE_ROWS=0 the shared kernel
// without staging, -DSHARED_WARPS=8 the shared kernel of at most 8
// warps.

#include <cuda_runtime.h>
#include <stdint.h>

#define WARP 32
#define FULL_MASK 0xFFFFFFFFu
#ifndef MAX_ROWS
#define MAX_ROWS 8          // rows a lane holds at most
#endif
#ifndef MAX_WARPS
#define MAX_WARPS 8         // warps a pair in the global kernel
#endif
#ifndef SHARED_WARPS
#define SHARED_WARPS 16     // warps a pair at most in the shared kernel
#endif
#ifndef SHARED_ROWS
#define SHARED_ROWS 2048    // most rows of a bucket the shared kernel takes
#endif
#ifndef STAGE_ROWS
#define STAGE_ROWS 4        // most rows a lane whose scores are staged
#endif
#ifndef ABLATE
#define ABLATE 0
#endif
#ifndef RING_COLS
#define RING_COLS 4         // columns of a boundary slot
#endif
#ifndef RING_SLOTS
#define RING_SLOTS 8        // slots of a boundary ring
#endif
#define STAGE_COLS 32       // columns a row in the score window
#define EPOCH 8             // columns a row fills at a time
#define WIN_ROWS 32         // the walk's window: rows
#define WIN_DIAGS 64        // and diagonals
#define LOADS 8             // window bytes a thread has in flight
#define PUBLISH 32          // columns a global boundary is published in
#define PREFETCH 24         // columns ahead a row asks L1 for its scores
#define MAX_STRIPS 8192     // strips a pair at most: the counts' shared memory
#define STAMP_MAX 32768     // clock64 stamps kept by a -DSTAMP build
#define NEG (-1e30f)
#define STATE_E 1
#define STATE_F 2
#define E_OPEN_BIT 4
#define F_OPEN_BIT 8
#define MOVE_I 1            // path byte: the move consumes profile 1
#define MOVE_J 2            // and profile 2

static_assert(WIN_ROWS == WARP, "a warp loads a diagonal of the walk's window");

struct Costs {
    float go, ge;           // gap open and extend
    float go_t, ge_t;       // the terminal ones: float32(g * term_scale)
};

__host__ __device__ __forceinline__ int ceil_div(int a, int b) {
    return (a + b - 1) / b;
}

// Strips of the fewest: 32 MAX_ROWS rows each.
__host__ __device__ __forceinline__ int strips_for(int rows) {
    return ceil_div(rows, WARP * MAX_ROWS);
}

// A pair's strips and rows a lane on a block of `warps` warps: in the
// shared kernel spread over all of them, in the global one the fewest.
struct Layout {
    int n, R;
};

__host__ __device__ __forceinline__ Layout layout_for(bool shared, int rows,
                                                      int warps) {
    Layout g;
    g.n = strips_for(rows);
    g.R = ceil_div(rows, WARP * g.n);
    if (shared) {
        g.R = ceil_div(rows, WARP * warps);
        g.n = ceil_div(rows, WARP * g.R);
    }
    return g;
}

// The bucket L1 takes the shared kernel: its longest pair's rows spread
// over SHARED_WARPS warps at most MAX_ROWS a lane, and at most
// SHARED_ROWS.
static bool shared_for(int L1) {
    return L1 + 1 <= SHARED_ROWS && L1 + 1 <= WARP * SHARED_WARPS * MAX_ROWS;
}

// Rows a lane the score window of the shared kernel on `warps` warps is
// sized for (0: not staged): the bucket's longest pair at most
// STAGE_ROWS a lane.
static int stage_rows_for(int L1, int warps) {
    const int R = layout_for(true, L1 + 1, warps).R;
    return R <= STAGE_ROWS ? R : 0;
}

// A strip's score window: 32 R rows of STAGE_COLS (+1 for even R) floats.
__host__ __device__ __forceinline__ int stage_stride(int R) {
    return R * WARP * (STAGE_COLS + 1);
}

// The block's shared memory, in bytes from its start: the boundaries'
// mbarriers, their rings, the warps' score windows, the global
// boundaries' published counts, the walk's window and its cursor.
struct Smem {
    int bar, ring, stage, done, win, cur, bytes;
};

__host__ __device__ __forceinline__ Smem smem_plan(bool shared, int L1,
                                                   int warps,
                                                   int stage_rows) {
    Smem m;
    const int edges = shared ? warps - 1 : 0;
    m.bar = 0;
    m.ring = m.bar + edges * 2 * RING_SLOTS * 8;
    m.stage = m.ring + edges * RING_SLOTS * RING_COLS * 8;
    m.done = m.stage + warps * stage_stride(stage_rows) * 4;
    m.win = m.done + (shared ? 0 : strips_for(L1 + 1)) * 4;
    m.cur = m.win + 2 * WIN_DIAGS * WIN_ROWS;  // the window, its moves
    m.bytes = m.cur + 4 * 4;
    return m;
}

#ifdef STAMP
__device__ long long g_stamps[STAMP_MAX];
#define STAMP_AT(slot) (g_stamps[(slot)] = clock64())
#else
__device__ long long g_stamps[1];
#define STAMP_AT(slot) ((void)0)
#endif

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                     smem_addr(bar)),
                 "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    unsigned long long state;
    asm volatile("mbarrier.arrive.shared::cta.b64 %0, [%1];"
                 : "=l"(state)
                 : "r"(smem_addr(bar))
                 : "memory");
    (void)state;
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
    unsigned done;
    do {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done)
            : "r"(smem_addr(bar)), "r"(parity)
            : "memory");
    } while (!done);
}

__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                     smem_addr(dst)),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void copy_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

// All but the newest group of this thread's copies have landed.
__device__ __forceinline__ void copy_wait_one() {
    asm volatile("cp.async.wait_group 1;" ::: "memory");
}

__device__ __forceinline__ void copy_wait_all() {
    asm volatile("cp.async.wait_all;" ::: "memory");
}

// A hint to bring the 32-byte sector at p into L1.
__device__ __forceinline__ void prefetch_l1(const float* p) {
    asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

// Wait until at least `need` columns of a global boundary are published;
// returns the count seen.
__device__ __forceinline__ int wait_columns(volatile int* done, int need) {
    int have;
    while ((have = *done) < need) __nanosleep(20);
    __threadfence_block();  // the buffer's columns after the count
    return have;
}

// One pair as the block sees it.
struct Pair {
    const float* sb;        // its (L1, L2) column scores
    int L2, l1, l2, n;      // n strips
    Costs k;
    uint8_t* pb;            // its pointers: cell (i, j) at pb[(i + j) ds + i]
    long long ds;
    float* score_b;
    // shared kernel: boundary s at ring + s RING_SLOTS RING_COLS, its full
    // barriers at bar + 2 s RING_SLOTS and empty ones RING_SLOTS after;
    // global: boundary s at bufs + s (L2 + 1), published count done[s]
    float2* ring_buf;
    uint64_t* bar;
    float2* bufs;
    volatile int* done;
};

// Lane 0's reader of the boundary above strip s (s > 0), in the ring
// (SHARED) or the global buffer.
template <bool SHARED>
struct Above {
    const Pair& p;
    int s, avail;

    // The (H, F) of column x, x = 0, 1, ... in order.
    __device__ __forceinline__ float2 take(int x, int cols) {
        if (ABLATE & 4) return make_float2(NEG, NEG);
        if constexpr (SHARED) {
            const int e = s - 1;
            const int q = (x / RING_COLS) % RING_SLOTS;
            const int use = x / (RING_COLS * RING_SLOTS);
            uint64_t* full = p.bar + 2 * e * RING_SLOTS + q;
            if (x % RING_COLS == 0) mbar_wait(full, use & 1);
            const float2 v =
                p.ring_buf[e * RING_SLOTS * RING_COLS +
                           x % (RING_SLOTS * RING_COLS)];
            if (x % RING_COLS == RING_COLS - 1 || x == cols - 1)
                mbar_arrive(full + RING_SLOTS);  // its slot is read
            return v;
        } else {
            const float2* bin = p.bufs + (long long)(s - 1) * (p.L2 + 1);
            if (x >= avail) avail = wait_columns(p.done + s - 1, x + 1);
            return __ldcg(bin + x);
        }
    }
};

// Lane 31's writer of strip s's bottom row, column c, to the next strip.
template <bool SHARED>
__device__ __forceinline__ void hand_on(const Pair& p, int s, int c, int cols,
                                        float h, float f) {
    if (ABLATE & 4) return;
    if constexpr (SHARED) {
        const int q = (c / RING_COLS) % RING_SLOTS;
        const int use = c / (RING_COLS * RING_SLOTS);
        uint64_t* full = p.bar + 2 * s * RING_SLOTS + q;
        if (c % RING_COLS == 0 && use > 0)
            mbar_wait(full + RING_SLOTS, (use - 1) & 1);  // slot read
        p.ring_buf[s * RING_SLOTS * RING_COLS +
                   c % (RING_SLOTS * RING_COLS)] = make_float2(h, f);
        if (c % RING_COLS == RING_COLS - 1 || c == cols - 1)
            mbar_arrive(full);
    } else {
        __stcg(p.bufs + (long long)s * (p.L2 + 1) + c, make_float2(h, f));
        if ((c & (PUBLISH - 1)) == PUBLISH - 1 || c == cols - 1) {
            __threadfence_block();
            p.done[s] = c + 1;
        }
    }
}

// Copy the scores of epoch `ep` (score columns 8 ep - t - 1 + 0..7 of
// row t) of the rows lane / 8 * 8 + k (k = 0..7) of each r into the
// window: a warp instruction 4 rows of EPOCH consecutive columns.
template <int R>
__device__ __forceinline__ void stage_fill(float* sw, const Pair& p,
                                           int i_base, int ep, int k,
                                           int lane) {
    constexpr int RS = STAGE_COLS + (R & 1 ? 0 : 1);
    const int lr = k + EPOCH * (lane / EPOCH);  // the rows' lane
    const int jj = lane % EPOCH;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int t = lr * R + r;
        const int i = i_base + t;  // its H row; its scores' row i - 1
        const int cs = EPOCH * ep - t - 1 + jj;
        if (i >= 1 && i <= p.l1 && (unsigned)cs < (unsigned)p.l2)
            copy_async4(sw + (r * WARP + lr) * RS + (cs & (STAGE_COLS - 1)),
                        p.sb + (long long)(i - 1) * p.L2 + cs);
    }
}

// The walk of strip s of one pair by one warp, R rows a lane, in the
// shared kernel (SHARED) or the global one; sw the warp's score window
// when STAGED.
template <int R, bool SHARED, bool STAGED>
__device__ __forceinline__ void walk(int s, const Pair& p, float* sw,
                                     int lane) {
    constexpr int RS = STAGE_COLS + (R & 1 ? 0 : 1);
    const int l1 = p.l1, l2 = p.l2, L2 = p.L2;
    const Costs k = p.k;
    const int cols = l2 + 1;
    const int i_base = s * WARP * R;
    // the strip's last row on the grid ends its walk at column l2
    const int n_steps = min(WARP * R, l1 + 1 - i_base) - 1 + cols;
    const int i0 = i_base + lane * R;  // the lane's first row
    const int rmax = l1 - i0;          // rows r <= rmax lie on the grid
    const bool feeds = s + 1 < p.n;
#ifdef STAMP
    const bool stamp = blockIdx.x == 0 && s == 0 && lane == 0;
#endif
    float h[R], e[R], f[R], hd[R], goe[R], gee[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        h[r] = e[r] = f[r] = hd[r] = NEG;
        const bool e_term = i0 + r == 0 || i0 + r == l1;
        goe[r] = e_term ? k.go_t : k.go;
        gee[r] = e_term ? k.ge_t : k.ge;
    }
    if (STAGED) {  // epochs 0 and 1 before the first step
        for (int kk = 0; kk < EPOCH; ++kk)
            stage_fill<R>(sw, p, i_base, 0, kk, lane);
        copy_commit();
        for (int kk = 0; kk < EPOCH; ++kk)
            stage_fill<R>(sw, p, i_base, 1, kk, lane);
        copy_commit();
    }
    // lane 0: the row above its row 0's cell of the next step
    Above<SHARED> above{p, s, 0};
    float2 nxt = make_float2(NEG, NEG);
    if (lane == 0 && s > 0) nxt = above.take(0, cols);
    float hu = NEG, fu = NEG;  // H and F above row 0's cell
    // s(i0 + r - 1, c - 1) of row r at column c = tau - lane R - r lies
    // at sl + tau + r (L2 - 1); the cell's byte at pl + tau ds + r
    const float* sl = p.sb + (long long)(i0 - 1) * L2 - lane * R - 1;
    uint8_t* pl = p.pb + (long long)i_base * p.ds + i0;

    for (int tau = 0; tau < n_steps; ++tau) {
#ifdef STAMP
        if (stamp && tau < STAMP_MAX - 4) {
            STAMP_AT(tau);
            if (tau == 0) g_stamps[STAMP_MAX - 4] = n_steps;
        }
#endif
        const int c0 = tau - lane * R;  // row 0's column
        if (lane == 0) {
            hu = nxt.x;
            fu = nxt.y;
            if (s > 0 && tau + 1 < cols) nxt = above.take(tau + 1, cols);
        }
        if (STAGED) {
            const int kk = tau % EPOCH;
            if (kk == 0) {  // this epoch's copies have landed
                copy_wait_one();
                __syncwarp();
            }
            stage_fill<R>(sw, p, i_base, tau / EPOCH + 2, kk, lane);
            if (kk == EPOCH - 1) copy_commit();
        }
        const float* st = sl + tau;
        uint8_t* pt = pl + (long long)tau * p.ds;
        if (!STAGED && !(ABLATE & 1)) {
            // the row entering a new sector of its scores asks for the
            // one PREFETCH columns ahead
            const int rp = (c0 - 1 + PREFETCH) & 7;
            if (rp < R && rp <= rmax &&
                (unsigned)(c0 - rp - 1 + PREFETCH) < (unsigned)l2 &&
                (rp > 0 || i0 > 0))
                prefetch_l1(st + (long long)rp * (L2 - 1) + PREFETCH);
        }
#pragma unroll
        for (int r = R - 1; r >= 0; --r) {
            const int c = c0 - r;
            const bool on_row = r <= rmax;
            const bool act = on_row && (unsigned)c < (unsigned)cols;
            // the column score, 0 on row 0 and column 0
            float sv = 0.0f;
            if (!(ABLATE & 1) && on_row && (unsigned)(c - 1) < (unsigned)l2 &&
                (r || i0))
                sv = STAGED ? sw[(r * WARP + lane) * RS +
                                 ((c - 1) & (STAGE_COLS - 1))]
                            : __ldg(st + (long long)r * (L2 - 1));
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
                if (!(ABLATE & 2))
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
                if (r == rmax) *p.score_b = h[r];  // H(l1, l2)
        }
        if (feeds && lane == WARP - 1) {  // the bottom row, to the next strip
            const int c = c0 - (R - 1);
            if ((unsigned)c < (unsigned)cols)
                hand_on<SHARED>(p, s, c, cols, h[R - 1], f[R - 1]);
        }
        hu = __shfl_up_sync(FULL_MASK, h[R - 1], 1);
        fu = __shfl_up_sync(FULL_MASK, f[R - 1], 1);
    }
    if (STAGED) copy_wait_all();
}

// walk<rows> for 1 <= rows <= R
template <int R, bool SHARED>
__device__ __forceinline__ void walk_rows(int rows, bool staged, int s,
                                          const Pair& p, float* sw,
                                          int lane) {
    if (rows == R) {
        if constexpr (SHARED && R <= STAGE_ROWS) {
            if (staged) {
                walk<R, SHARED, true>(s, p, sw, lane);
                return;
            }
        }
        walk<R, SHARED, false>(s, p, sw, lane);
    } else if constexpr (R > 1) {
        walk_rows<R - 1, SHARED>(rows, staged, s, p, sw, lane);
    }
}

// The traceback of the pair from its pointers, by the whole block (see
// the header); writes path_b[Lp - 1], path_b[Lp - 2], ... and *len_b.
// Per window the block also tabulates, for each cell whose successors
// lie in the window, the state after a move out of it in each state
// (bits 0-1 after M, 2-3 after E, 4-5 after F), so that thread 0's move
// reads one byte.
__device__ __forceinline__ void trace(const Pair& p, uint8_t* path_b, int Lp,
                                      int* len_b, uint8_t* win, int* cur) {
    uint8_t* next = win + WIN_DIAGS * WIN_ROWS;
    int i = p.l1, j = p.l2;  // the window's corner, the same in all threads
    int state = 0, n = 0;    // thread 0's
    for (bool first = true;; first = false) {
        // cell (a, b) at x = (k0 - a - b) WIN_ROWS + a - i + WIN_ROWS - 1
        const int k0 = i + j;
        // a warp a diagonal's WIN_ROWS bytes, LOADS diagonals in flight
        const int lane = threadIdx.x % WIN_ROWS, warps = blockDim.x / WARP;
        const int ii = i - (WIN_ROWS - 1) + lane;
        for (int d0 = threadIdx.x / WARP; d0 < WIN_DIAGS;
             d0 += LOADS * warps) {
            uint8_t v[LOADS];
#pragma unroll
            for (int q = 0; q < LOADS; ++q) {
                const int kk = k0 - d0 - q * warps;
                v[q] = d0 + q * warps < WIN_DIAGS && ii >= 0 && ii <= kk
                           ? __ldcg(p.pb + kk * p.ds + ii)
                           : (uint8_t)0;
            }
#pragma unroll
            for (int q = 0; q < LOADS; ++q)
                if (d0 + q * warps < WIN_DIAGS)
                    win[(d0 + q * warps) * WIN_ROWS + lane] = v[q];
        }
        __syncthreads();
        for (int x = threadIdx.x; x < WIN_DIAGS * WIN_ROWS; x += blockDim.x) {
            const int d = x / WIN_ROWS, r = x % WIN_ROWS;
            if (d + 2 < WIN_DIAGS && r > 0) {
                const int c = win[x];
                const int after_m = win[x + 2 * WIN_ROWS - 1] & 3;
                const int after_e = c & E_OPEN_BIT ? win[x + WIN_ROWS] & 3
                                                   : STATE_E;
                const int after_f = c & F_OPEN_BIT
                                        ? win[x + WIN_ROWS - 1] & 3
                                        : STATE_F;
                next[x] = (uint8_t)(after_m | after_e << 2 | after_f << 4);
            }
        }
        __syncthreads();
        if (threadIdx.x == 0) {
            int a = i, b = j;
            int x = WIN_ROWS - 1;  // (a, b)'s cell
            if (first) state = win[x] & 3;
            // moves whose successor lies in the window
            while (a > 0 && b > 0 && a - 1 >= i - (WIN_ROWS - 1) &&
                   k0 - (a + b - 2) < WIN_DIAGS) {
                const int t = next[x];
                int move;
                if (state == 0) {
                    move = MOVE_I | MOVE_J;
                    x += 2 * WIN_ROWS - 1;
                } else if (state == STATE_E) {
                    move = MOVE_J;
                    x += WIN_ROWS;
                } else {
                    move = MOVE_I;
                    x += WIN_ROWS - 1;
                }
                state = (t >> 2 * state) & 3;
                a -= move & MOVE_I;
                b -= move >> 1;
                path_b[Lp - 1 - n++] = (uint8_t)move;
            }
            if (a == 0 || b == 0) {  // along row 0 or column 0
                for (; b > 0; --b) path_b[Lp - 1 - n++] = MOVE_J;
                for (; a > 0; --a) path_b[Lp - 1 - n++] = MOVE_I;
            }
            cur[0] = a;
            cur[1] = b;
        }
        __syncthreads();
        i = cur[0];
        j = cur[1];
        if (i == 0 && j == 0) break;
    }
    if (threadIdx.x == 0) *len_b = n;
}

// SHARED: the shared kernel (rows spread over the warps, boundaries in
// the ring, scores staged when stage_rows > 0); else the global one.
template <bool SHARED>
__global__ void __launch_bounds__(WARP * (SHARED ? SHARED_WARPS : MAX_WARPS))
profile_dp_kernel(const float* __restrict__ s, const int* __restrict__ len1,
                  const int* __restrict__ len2, int B, int L1, int L2,
                  Costs k, int stage_rows, float* __restrict__ score,
                  uint8_t* ptr, uint8_t* __restrict__ path,
                  int* __restrict__ path_len, float2* __restrict__ bufs) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int b = blockIdx.x;
    const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
    const int warps = blockDim.x / WARP;
    const Smem m = smem_plan(SHARED, L1, warps, stage_rows);
    const long long R1 = L1 + 1;
    Pair p;
    p.sb = s + (long long)b * L1 * L2;
    p.L2 = L2;
    p.l1 = min(max(len1[b], 0), L1);
    p.l2 = min(max(len2[b], 0), L2);
    const Layout g = layout_for(SHARED, p.l1 + 1, warps);
    p.n = g.n;
    p.k = k;
    p.pb = ptr + b * R1;
    p.ds = (long long)B * R1;
    p.score_b = score + b;
    p.bar = (uint64_t*)(smem + m.bar);
    p.ring_buf = (float2*)(smem + m.ring);
    p.bufs = bufs + (long long)b * (strips_for(L1 + 1) - 1) * (L2 + 1);
    p.done = (volatile int*)(smem + m.done);
#ifdef STAMP
    if (b == 0 && threadIdx.x == 0) STAMP_AT(STAMP_MAX - 3);
#endif
    if (SHARED) {
        for (int x = threadIdx.x; x < 2 * (warps - 1) * RING_SLOTS;
             x += blockDim.x)
            mbar_init(p.bar + x, 1);
    } else {
        for (int x = threadIdx.x; x < strips_for(L1 + 1); x += blockDim.x)
            p.done[x] = 0;
    }
    __syncthreads();
    float* sw = (float*)(smem + m.stage) + warp * stage_stride(stage_rows);
    for (int st = warp; st < g.n; st += warps)
        walk_rows<MAX_ROWS, SHARED>(g.R, stage_rows > 0, st, p, sw, lane);
    __syncthreads();
#ifdef STAMP
    if (b == 0 && threadIdx.x == 0) STAMP_AT(STAMP_MAX - 2);
#endif
    if (!(ABLATE & 8))
        trace(p, path + b * (long long)(L1 + L2), L1 + L2, path_len + b,
              smem + m.win, (int*)(smem + m.cur));
#ifdef STAMP
    if (b == 0 && threadIdx.x == 0) STAMP_AT(STAMP_MAX - 1);
#endif
}

// A launch's plan: the kernel, warps a block, rows a lane of the score
// window (0: not staged), shared memory a block in bytes.
struct Plan {
    bool shared;
    int warps, stage_rows, bytes;
};

// The shared kernel may take as much dynamic shared memory as a block
// may have (set once); the device's SMs and that limit.
static cudaError_t shared_kernel_ready(int* sms, int* limit) {
    static int n = 0, optin = 0;
    cudaError_t err = cudaSuccess;
    if (n == 0) {
        int dev = 0;
        err = cudaGetDevice(&dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                                         dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(
                &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(
                profile_dp_kernel<true>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
        if (err != cudaSuccess) n = 0;
    }
    *sms = n;
    *limit = optin;
    return err;
}

// The plan for B pairs of the bucket L1.  The global kernel: a warp a
// strip, up to MAX_WARPS.  The shared kernel: the most warps, up to a
// strip of 32 rows each and SHARED_WARPS, at which all B blocks are
// resident on the card at once (the occupancy calculator on its
// registers and shared memory), so a call of few pairs spreads each over
// more warps and one of many keeps every pair in flight; and never fewer
// than the rows need at MAX_ROWS a lane.
static cudaError_t plan_for(int B, int L1, Plan* pl) {
    pl->shared = shared_for(L1);
    pl->stage_rows = 0;
    cudaError_t err = cudaSuccess;
    if (!pl->shared) {
        const int n = strips_for(L1 + 1);
        pl->warps = n < MAX_WARPS ? n : MAX_WARPS;
    } else {
        int sms = 0, limit = 0;
        err = shared_kernel_ready(&sms, &limit);
        const int w_min = ceil_div(L1 + 1, WARP * MAX_ROWS);
        const int w_max = ceil_div(L1 + 1, WARP);
        pl->warps = w_max < SHARED_WARPS ? w_max : SHARED_WARPS;
        for (; pl->warps > w_min && err == cudaSuccess; --pl->warps) {
            const int bytes = smem_plan(true, L1, pl->warps,
                                        stage_rows_for(L1, pl->warps))
                                  .bytes;
            int blocks = 0;
            if (bytes <= limit)
                err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &blocks, profile_dp_kernel<true>, WARP * pl->warps,
                    bytes);
            if ((long long)blocks * sms >= B) break;
        }
        pl->stage_rows = stage_rows_for(L1, pl->warps);
    }
    pl->bytes = smem_plan(pl->shared, L1, pl->warps, pl->stage_rows).bytes;
    return err;
}

extern "C" {

// The plan of a launch of B pairs of the bucket L1 into out (4 ints):
// the shared kernel (1) or the global one (0), warps a block, rows a lane
// of the score window (0: not staged), shared memory a block in bytes.
// Returns 0 or a CUDA error.
int profile_dp_plan(int B, int L1, void* out) {
    Plan pl;
    const cudaError_t err = plan_for(B, L1, &pl);
    int* o = (int*)out;
    o[0] = pl.shared ? 1 : 0;
    o[1] = pl.warps;
    o[2] = pl.stage_rows;
    o[3] = pl.bytes;
    return (int)err;
}

// Scratch bytes of a launch: per pair, the global boundaries between
// the bucket's strips of the fewest, L2 + 1 (H, F) pairs each.
long long profile_dp_scratch_bytes(int B, int L1, int L2) {
    const long long n = strips_for(L1 + 1);
    const long long bytes =
        (long long)B * (n - 1) * (L2 + 1) * (long long)sizeof(float2);
    return bytes > 0 ? bytes : 1;
}

// Registers per thread of the shared kernel (shared != 0) or the global
// one (cudaFuncGetAttributes), or a negative CUDA error.
int profile_dp_num_regs(int shared) {
    cudaFuncAttributes at;
    cudaError_t err = shared
        ? cudaFuncGetAttributes(&at, profile_dp_kernel<true>)
        : cudaFuncGetAttributes(&at, profile_dp_kernel<false>);
    return err == cudaSuccess ? at.numRegs : -(int)err;
}

// Copies the first n clock64 stamps of a -DSTAMP build to out (host
// memory): step tau of block 0's first strip at tau, that strip's steps
// at STAMP_MAX - 4, the kernel's start, the DP's end and the walk's end
// at STAMP_MAX - 3, - 2 and - 1.
// Returns the count copied (0 in other builds) or a negative CUDA error.
int profile_dp_stamps(void* out, int n) {
#ifdef STAMP
    n = n < STAMP_MAX ? n : STAMP_MAX;
    cudaError_t err = cudaMemcpyFromSymbol(out, g_stamps,
                                           n * sizeof(long long));
    return err == cudaSuccess ? n : -(int)err;
#else
    (void)out;
    (void)n;
    return 0;
#endif
}

// B pairs: s (B, L1, L2) float32 column scores, len1 and len2 (B,) int32,
// the gap costs (go_t and ge_t the terminal ones); writes score (B,)
// float32, the grid cells of ptr (L1 + L2 + 1, B, L1 + 1) uint8, each
// pair's moves at the end of its row of path (B, L1 + L2) uint8 and
// their count in path_len (B,) int32.  Returns cudaGetLastError() after
// the launch (0 on success).
int profile_dp_launch(const void* s, const void* len1, const void* len2,
                      int B, int L1, int L2, float go, float ge, float go_t,
                      float ge_t, void* score, void* ptr, void* path,
                      void* path_len, void* scratch, long long scratch_bytes,
                      void* stream) {
    if (B < 1 || L1 < 1 || L2 < 1 || strips_for(L1 + 1) > MAX_STRIPS)
        return (int)cudaErrorInvalidValue;
    if (scratch_bytes < profile_dp_scratch_bytes(B, L1, L2))
        return (int)cudaErrorInvalidValue;
    Plan pl;
    const cudaError_t err = plan_for(B, L1, &pl);
    if (err != cudaSuccess) return (int)err;
    const Costs k = {go, ge, go_t, ge_t};
    if (pl.shared)
        profile_dp_kernel<true><<<B, WARP * pl.warps, pl.bytes,
                                  (cudaStream_t)stream>>>(
            (const float*)s, (const int*)len1, (const int*)len2, B, L1, L2,
            k, pl.stage_rows, (float*)score, (uint8_t*)ptr, (uint8_t*)path,
            (int*)path_len, (float2*)scratch);
    else
        profile_dp_kernel<false><<<B, WARP * pl.warps, pl.bytes,
                                   (cudaStream_t)stream>>>(
            (const float*)s, (const int*)len1, (const int*)len2, B, L1, L2,
            k, 0, (float*)score, (uint8_t*)ptr, (uint8_t*)path,
            (int*)path_len, (float2*)scratch);
    return (int)cudaGetLastError();
}

const char* profile_dp_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
