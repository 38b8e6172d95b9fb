// Batched affine-gap Smith-Waterman local alignment on Hopper.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   sw_kernel  <- pepr_tpu/ops/pallas_sw.py::_kernel
//
// What it computes, for every pair b of the batch (the function of
// sw_align_numpy in ops/smith_waterman.py), in int32:
//   E(i,j) = max(H(i,j-1) - go, E(i,j-1) - ge)   opening wins ties
//   F(i,j) = max(H(i-1,j) - go, F(i-1,j) - ge)   opening wins ties
//   H(i,j) = max(0, H(i-1,j-1) + sub[q_i][t_j], E(i,j), F(i,j))
// with i over the query and j over the target.  Packed trackers
// (matches << 16 | length) ride along the chosen predecessor: diagonal
// first, then E, then F, and 0 where H <= 0.  The best cell is the one
// with the top score, the smallest query position among those, then
// the smallest target position: each query row keeps its own best by a
// strict > along the target, and a block reduction takes the first row
// with the top score (the Pallas kernel's per-lane best and final
// argmax).  F is exact, so any gap_open >= 0 and gap_extend >= 0 work.
//
// Design (simple and right first).  One thread block aligns one pair.
// Each thread owns R consecutive query rows and keeps their DP state
// (H of the last two anti-diagonals, E, F, their trackers and the
// row's running best) in registers.  The block walks the Lq + Lt - 1
// anti-diagonals; every cell of a diagonal is independent.  Within a
// thread the rows are updated from the last to the first, so a row
// reads its upper neighbour's values of the previous diagonals before
// they are overwritten.  The first row of a thread takes its upper
// neighbour's values from the previous thread, which publishes its last
// row's H, F and trackers in shared memory after every diagonal (double
// buffered, one __syncthreads per diagonal).  The target and the
// substitution table sit in shared memory.
//
// What bounds it on this card: int32 operations (about 20 per cell for
// the recurrence and its trackers) and, in this design, the barrier per
// anti-diagonal.  The bytes moved are the codes, a few bytes per cell
// row, so memory does not bind.  What this design leaves for the later
// fast version: Hopper's DPX instructions (__viaddmax_s32 for the
// add-then-max of E, F and the diagonal, __vimax3_s32 for the
// three-way max), skipping the PAD tails of the power-of-two buckets
// (rows and diagonals past the real lengths), a query profile instead
// of the table lookup, and packing several short pairs into one block
// (or one pair per warp with shuffles) so that the ramps of the
// anti-diagonal walk and the barriers cost less.

#include <cuda_runtime.h>
#include <stdint.h>

#define N_CODES 25      // codes 0..24; PAD = 24
#define PAD_CODE 24
#define SUB_LD 32       // row stride of the shared substitution table
#define MAX_LEN 4096    // longest query or target
#define MAX_THREADS 512
#define NEG_INF (-(1 << 28))

__device__ __forceinline__ int clamp_code(int c) {
    return (c < 0 || c >= N_CODES) ? PAD_CODE : c;
}

template <int R>
__global__ void __launch_bounds__(MAX_THREADS)
sw_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ t,
          const int32_t* __restrict__ sub, int Lq, int Lt, int go, int ge,
          float* __restrict__ score, int32_t* __restrict__ matches,
          int32_t* __restrict__ length, int32_t* __restrict__ q_end,
          int32_t* __restrict__ t_end) {
    __shared__ int32_t s_sub[N_CODES * SUB_LD];
    __shared__ int8_t s_t[MAX_LEN];
    __shared__ int32_t s_h[2][MAX_THREADS];
    __shared__ int32_t s_f[2][MAX_THREADS];
    __shared__ int32_t s_mlh[2][MAX_THREADS];
    __shared__ int32_t s_mlf[2][MAX_THREADS];
    __shared__ unsigned long long s_key[MAX_THREADS / 32];

    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int nth = blockDim.x;
    const int8_t* qb = q + (long long)b * Lq;
    const int8_t* tb = t + (long long)b * Lt;
    for (int x = tid; x < N_CODES * N_CODES; x += nth)
        s_sub[(x / N_CODES) * SUB_LD + x % N_CODES] = sub[x];
    for (int x = tid; x < Lt; x += nth) s_t[x] = (int8_t)clamp_code(tb[x]);

    const int i0 = tid * R;
    int qc[R];                        // query code of each row
    int hp1[R], hp2[R], e[R], f[R];   // H at diagonals k-1, k-2; E, F
    int mlh1[R], mlh2[R], mle[R], mlf[R];
    int bv[R], bml[R], bj[R];         // the row's best: score, tracker, j
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int i = i0 + r;
        qc[r] = i < Lq ? clamp_code(qb[i]) : PAD_CODE;
        hp1[r] = hp2[r] = 0;
        e[r] = f[r] = NEG_INF;
        mlh1[r] = mlh2[r] = mle[r] = mlf[r] = 0;
        bv[r] = bml[r] = bj[r] = 0;
    }
    // row i0 - 1 (the previous thread's last row, or the boundary above
    // row 0): H and tracker at diagonals k-1 and k-2, F and its tracker
    // at k-1
    int nh1 = 0, nh2 = 0, nf1 = NEG_INF, nmlh1 = 0, nmlh2 = 0, nmlf1 = 0;
    __syncthreads();

    const int n_diag = Lq + Lt - 1;
    for (int k = 0; k < n_diag; ++k) {
        if (tid > 0 && k > 0) {
            const int buf = (k - 1) & 1;
            nh2 = nh1;
            nmlh2 = nmlh1;
            nh1 = s_h[buf][tid - 1];
            nf1 = s_f[buf][tid - 1];
            nmlh1 = s_mlh[buf][tid - 1];
            nmlf1 = s_mlf[buf][tid - 1];
        }
#pragma unroll
        for (int r = R - 1; r >= 0; --r) {
            const int i = i0 + r;
            const int j = k - i;
            if (i < Lq && j >= 0 && j < Lt) {
                const int u = r > 0 ? r - 1 : 0;               // row i-1
                const int up_h = r > 0 ? hp1[u] : nh1;         // H(i-1, j)
                const int up_f = r > 0 ? f[u] : nf1;           // F(i-1, j)
                const int up_mlh = r > 0 ? mlh1[u] : nmlh1;
                const int up_mlf = r > 0 ? mlf[u] : nmlf1;
                const int dg_h = r > 0 ? hp2[u] : nh2;         // H(i-1, j-1)
                const int dg_ml = r > 0 ? mlh2[u] : nmlh2;
                const int tc = s_t[j];
                // E: gap consuming the target, from (i, j-1)
                const int eo = hp1[r] - go, ee = e[r] - ge;
                const bool e_open = eo >= ee;
                const int ev = e_open ? eo : ee;
                const int mle_v = (e_open ? mlh1[r] : mle[r]) + 1;
                // F: gap consuming the query, from (i-1, j)
                const int fo = up_h - go, fe = up_f - ge;
                const bool f_open = fo >= fe;
                const int fv = f_open ? fo : fe;
                const int mlf_v = (f_open ? up_mlh : up_mlf) + 1;
                // diagonal: match or mismatch
                const int d = dg_h + s_sub[qc[r] * SUB_LD + tc];
                const int mld = dg_ml + ((qc[r] == tc) << 16) + 1;
                const int h = max(max(d, ev), max(fv, 0));
                const int ml = h <= 0 ? 0
                             : (h == d ? mld : (h == ev ? mle_v : mlf_v));
                if (h > bv[r]) {
                    bv[r] = h;
                    bml[r] = ml;
                    bj[r] = j;
                }
                hp2[r] = hp1[r];
                hp1[r] = h;
                e[r] = ev;
                f[r] = fv;
                mlh2[r] = mlh1[r];
                mlh1[r] = ml;
                mle[r] = mle_v;
                mlf[r] = mlf_v;
            }
        }
        const int buf = k & 1;
        s_h[buf][tid] = hp1[R - 1];
        s_f[buf][tid] = f[R - 1];
        s_mlh[buf][tid] = mlh1[R - 1];
        s_mlf[buf][tid] = mlf[R - 1];
        __syncthreads();
    }

    // the thread's best: top score, first row
    int v = bv[0], vi = i0, vj = bj[0], vml = bml[0];
#pragma unroll
    for (int r = 1; r < R; ++r) {
        if (bv[r] > v) {
            v = bv[r];
            vi = i0 + r;
            vj = bj[r];
            vml = bml[r];
        }
    }
    // the block's best: max of (score, -row) as one 64-bit key
    const unsigned long long mine =
        ((unsigned long long)(unsigned)v << 32) | (0xFFFFFFFFu - (unsigned)vi);
    unsigned long long key = mine;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long o = __shfl_down_sync(0xFFFFFFFFu, key, off);
        key = o > key ? o : key;
    }
    if ((tid & 31) == 0) s_key[tid >> 5] = key;
    __syncthreads();
    if (tid == 0) {
        unsigned long long m = s_key[0];
        for (int w = 1; w < nth / 32; ++w) m = s_key[w] > m ? s_key[w] : m;
        s_key[0] = m;
    }
    __syncthreads();
    if (mine == s_key[0]) {
        score[b] = (float)v;
        matches[b] = vml >> 16;
        length[b] = vml & 0xFFFF;
        q_end[b] = vi;
        t_end[b] = vj;
    }
}

// Threads for a query of Lq rows: R = 4 rows a thread (8 above 2,048),
// rounded up to whole warps (at most MAX_THREADS).
static int sw_threads(int Lq) {
    const int rows = Lq <= 2048 ? 4 : 8;
    const int n = (Lq + rows - 1) / rows;
    return (n + 31) / 32 * 32;
}

extern "C" {

int sw_max_len(void) { return MAX_LEN; }

int sw_launch(const void* q, const void* t, const void* sub, int B, int Lq,
              int Lt, int gap_open, int gap_extend, void* score,
              void* matches, void* length, void* q_end, void* t_end,
              void* stream) {
    if (B < 1 || Lq < 1 || Lt < 1 || Lq > MAX_LEN || Lt > MAX_LEN)
        return (int)cudaErrorInvalidValue;
    const dim3 grid(B), block(sw_threads(Lq));
    cudaStream_t s = (cudaStream_t)stream;
    const int8_t* qp = (const int8_t*)q;
    const int8_t* tp = (const int8_t*)t;
    const int32_t* sp = (const int32_t*)sub;
    if (Lq <= 2048)
        sw_kernel<4><<<grid, block, 0, s>>>(
            qp, tp, sp, Lq, Lt, gap_open, gap_extend, (float*)score,
            (int32_t*)matches, (int32_t*)length, (int32_t*)q_end,
            (int32_t*)t_end);
    else
        sw_kernel<8><<<grid, block, 0, s>>>(
            qp, tp, sp, Lq, Lt, gap_open, gap_extend, (float*)score,
            (int32_t*)matches, (int32_t*)length, (int32_t*)q_end,
            (int32_t*)t_end);
    return (int)cudaGetLastError();
}

const char* sw_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
