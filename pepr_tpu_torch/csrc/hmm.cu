// Plan7 local Forward / Viterbi scoring of (sequence, profile) pairs on
// Hopper.
//
// Not a port of a TPU kernel: the JAX package scores with an XLA
// lax.scan (pepr_tpu/ops/hmm.py:206 viterbi_segment, driven by
// profile_score_pairs).  Its plain PyTorch version is
// ops/hmm.py::viterbi_score_batch, which follows that scan step for
// step; this kernel computes the same function and is held against it
// within a stated tolerance (sums in another order, approximate exp2 and
// log2).
//
// What it computes, for pair b = (sequence s, profile h), over the
// sequence's first L = min(lens[s], lpad) residues and the profile's
// first M = min(m_lens[h], mpad) match states, in float32 and in bits,
// with op = logaddexp2 (Forward, FORWARD = true) or max (Viterbi):
//   vm'[k] = e[k, c_i] + op(op(vm[k-1] + tmm[k-1], vi[k-1] + tim[k-1]),
//                           op(vd[k-1] + tdm[k-1], entry))
//   vi'[k] = op(vm[k] + tmi[k], vi[k] + tii[k])
//   vd'[k] = op(vm'[k-1] + tmd[k-1], vd'[k-1] + tdd[k-1])
//   total  = op over every (i, k) of vm'[k]
// entry = -log2(M); e = 0 for residue codes outside 0..19 (X, GAP, PAD);
// every state starts at the sentinel NEG = -1e30, and what enters column
// 0 from the left is NEG, as in the reference (no -inf, so no NaN from
// inf - inf).  Cells outside L x M never feed a real cell and add
// nothing to the total, so the kernel walks the real cells only, and
// lpad matters only as a cap on L.  Returns the raw total; the wrapper
// subtracts the null correction.
//
// Design.  A group of T threads scores one pair: T = 32, a warp (four
// pairs a block, no block barrier), for profiles up to 256 columns, and
// a block of 128 or 512 threads above (ops/hmm_kernel.py::THREADS; other
// configurations are built for the variants table of chip_smoke.py).
// Thread t owns ce = ceil(M / T) consecutive match states [t ce, t ce +
// ce) and keeps their vm, vi, vd and the seven transitions of its
// columns in registers (arrays of C >= ce, a template parameter; the
// loops are unrolled).  The profile comes as a walk pack
// (ops/hmm_kernel.py::walk_pack, built once per mpad pack): column k =
// t ce + j of profile h sits in slot j T + t, so the group's loads are
// coalesced.  A slot is two float4s, (tmm[k-1], tim[k-1], tdm[k-1],
// tmi[k]) and (tii[k], tmd[k], tdd[k], 0), the shifted terms 0 at k = 0
// (what they add to is NEG), read once a pair; emissions are 21 rows of
// slots, the 20 residues and a row of zeros, read a row ahead of their
// use.  Per sequence position:
//   1. each thread takes the previous thread's last old states (a
//      shuffle; lane 0 from the warp before, through shared memory) and
//      walks its columns: vm', vi', the total, and the delete chain from
//      its first column on as if nothing entered there, S_j =
//      op(vm'[k] + tmd[k], S_{j-1} + tdd[k]) (the chain into k + 1);
//   2. the threads' maps x -> op(S, x + A), A the sum of a thread's tdd
//      (fixed for the pair), are scanned in thread order, by shuffles
//      in a warp and over the warps' maps through shared memory, giving
//      x_in, the chain's value at the thread's first column (NEG at
//      column 0); lane 31 also leaves what the next warp's lane 0 needs
//      to compute its feed for the next position, so one barrier a
//      position suffices (buffers by the position's parity);
//   3. vd'[k] = op(S_{j-1}, x_in + A_{j-1}), A_j the thread's prefix
//      sums of tdd, computed once into shared memory: the columns are
//      independent of each other (no serial chain).
// Forward's total is an online log-sum-exp2 a thread (a running max and
// a sum of exp2), combined in a fixed order at the end.  A pair's score
// depends only on the pair: the batch and its order change nothing (the
// enhancer compares scores with ==): nothing is summed across pairs.
//
// logaddexp2 runs on the special-function unit (MUFU), in bits:
// op(a, b) = max + lg2(1 + ex2(-|a - b|)) with ex2.approx.ftz and
// lg2.approx.ftz.  vm' keeps the reference's op(op(a, b), op(c, entry)),
// so its rounding follows the plain version's over 4,096-row pairs.
//
// What bounds it on this card: MUFU results, 16 a clock on each of the
// 132 SMs.  The function needs 9 a real cell (chip_smoke.py's
// HMM_MUFU_PER_CELL): the match state's logaddexp2 of four terms is one
// max, three ex2 (the max's own term is 1) and one lg2 (4), the insert's
// and the delete's two-term ones an ex2 and a lg2 each (2 + 2), and the
// total one ex2 (1).  This design spends 13 (the pairwise vm' 6, and the
// lane-parallel chain is composed in step 1 and applied in step 3, a
// logaddexp2 more than the function), so it cannot pass 9/13 of that
// bound.  Below it: the scan's shuffles and op2s (5 + log2(T / 32) + 3
// logaddexp2s a thread a position, heavy where ce is small), the
// barrier, and the per-position latency of the chain.

#include <cuda_runtime.h>
#include <stdint.h>

#define WARP 32
#define N_AA 20
#define EMIT_ROWS 21
#define MAX_MPAD 4096
#define PAIR_BLOCK 128  // threads of a block of warp-wide groups
#define XCH 8            // floats a warp leaves for the others a position

// (T threads a pair, C columns a thread at most, blocks an SM for the
// register budget), by ascending C for each T: a launch takes the first
// with its T and C >= ceil(mpad / T)
#define HMM_CONFIGS(X)                                                    \
    X(32, 2, 8) X(32, 8, 4) X(64, 4, 12) X(128, 2, 8) X(128, 8, 4)        \
    X(256, 4, 3) X(256, 16, 1) X(512, 8, 1)

static constexpr float NEG = -1e30f;
static constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// log2(1 + x), x >= 0
__device__ __forceinline__ float lg2_1p(float x) {
    float y;
    asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(1.0f + x));
    return y;
}

template <bool FORWARD>
__device__ __forceinline__ float op2(float a, float b) {
    if (FORWARD) return fmaxf(a, b) + lg2_1p(ex2(-fabsf(a - b)));
    return fmaxf(a, b);
}

template <int T>
struct Shape {
    static constexpr int BLOCK = T == WARP ? PAIR_BLOCK : T;
    static constexpr int GROUPS = BLOCK / T;  // pairs a block
    static constexpr int WARPS = T / WARP;    // warps a pair
};

template <bool FORWARD, int T, int C, int MINB>
__global__ void __launch_bounds__(Shape<T>::BLOCK, MINB)
hmm_kernel(const int8_t* __restrict__ codes, int lmax,
           const int* __restrict__ lens, const float4* __restrict__ rec,
           const float* __restrict__ emit, const int* __restrict__ m_lens,
           int mpad, int slots, const int* __restrict__ seq_idx,
           const int* __restrict__ hmm_idx, int B, int lpad,
           float* __restrict__ out) {
    constexpr int GROUPS = Shape<T>::GROUPS, W = Shape<T>::WARPS;
    constexpr int WS = W > 1 ? W : 1;
    __shared__ float a_pre[Shape<T>::BLOCK * C];  // A_j, [group][j][t]
    // by row parity, each warp's lane 31: its map (A, S) composed over
    // the warp, and what the next warp's lane 0 needs of it for the next
    // position's feed (vm', vi', the exclusive map (xs, xa), S_{n-2},
    // A_{n-2})
    __shared__ float xch[2][XCH][WS];
    __shared__ float tots[2][WS];  // each warp's total

    const int g = threadIdx.x / T;
    const int t = threadIdx.x % T;
    const int lane = threadIdx.x & (WARP - 1);
    const int warp = t / WARP;  // in the pair
    const long long pair = (long long)blockIdx.x * GROUPS + g;
    // a whole group returns: a warp when GROUPS > 1, else the block
    if (pair >= B) return;

    const int s = seq_idx[pair];
    const int h = hmm_idx[pair];
    const int L = min(lens[s], lpad);
    const int M = min(m_lens[h], mpad);
    const float entry = -log2f(fmaxf((float)M, 1.0f));
    const int ce = (M + T - 1) / T;
    const int n = max(0, min(ce, M - t * ce));  // this thread's columns
    const float4* R = rec + ((long long)h * slots + t) * 2;  // + 2 j T
    const float* E = emit + (long long)h * EMIT_ROWS * slots + t;
    float* Ap = a_pre + g * T * C + t;  // A_j at Ap[j T]

    // the pair's transitions, held in registers for the whole walk, and
    // A_j = tdd[k0] + ... + tdd[k0 + j] in shared memory
    float t_mm[C], t_im[C], t_dm[C], t_mi[C], t_ii[C], t_md[C], t_dd[C];
    float a_sum = 0.0f, a_prev = 0.0f;  // A_{n-1}, A_{n-2}
#pragma unroll
    for (int j = 0; j < C; ++j) {
        if (j < n) {
            const float4 q0 = __ldg(R + 2 * j * T);
            const float4 q1 = __ldg(R + 2 * j * T + 1);
            t_mm[j] = q0.x;
            t_im[j] = q0.y;
            t_dm[j] = q0.z;
            t_mi[j] = q0.w;
            t_ii[j] = q1.x;
            t_md[j] = q1.y;
            t_dd[j] = q1.z;
            a_prev = a_sum;
            a_sum += q1.z;
            Ap[j * T] = a_sum;
        }
    }
    float vm[C], vi[C], vd[C];
#pragma unroll
    for (int j = 0; j < C; ++j) vm[j] = vi[j] = vd[j] = NEG;
    float lm = NEG, li = NEG, ld = NEG;  // the last column's old states
    // lane 0: the previous warp's lane 31's, from xch (NEG at warp 0)
    float fm = NEG, fi = NEG, fd = NEG;
    // Forward's running total: tot_m + log2(tot_s); Viterbi's: tot_m
    float tot_m = NEG, tot_s = 0.0f;

    // emissions of the current row, and of the next one, loaded a row
    // ahead; lane l holds the code of position (i & ~31) + l
    const int8_t* seq = codes + (long long)s * lmax;
    float em[C], en[C];
    int code = L > 0 ? (int)seq[min(lane, L - 1)] : 0;
    {
        const int c = __shfl_sync(FULL, code, 0);
        const float* Er = E + (long long)((c >= 0 && c < N_AA) ? c : N_AA) *
                                  slots;
#pragma unroll
        for (int j = 0; j < C; ++j)
            if (j < n) em[j] = __ldg(Er + j * T);
    }
    for (int i = 0; i < L; ++i) {
        if (i + 1 < L) {
            const int i1 = i + 1;
            if ((i1 & (WARP - 1)) == 0)
                code = (int)seq[min(i1 + lane, L - 1)];
            const int c = __shfl_sync(FULL, code, i1 & (WARP - 1));
            const float* Er = E +
                (long long)((c >= 0 && c < N_AA) ? c : N_AA) * slots;
#pragma unroll
            for (int j = 0; j < C; ++j)
                if (j < n) en[j] = __ldg(Er + j * T);
        }

        // the previous row's states at column k0 - 1
        float pm = __shfl_up_sync(FULL, lm, 1);
        float pi = __shfl_up_sync(FULL, li, 1);
        float pd = __shfl_up_sync(FULL, ld, 1);
        if (lane == 0) {
            pm = fm;
            pi = fi;
            pd = fd;
        }

        // 1. vm', vi', the total, and the chain with nothing entering
        float S = NEG, sp = NEG;   // S_{j}, S_{j-1}
        float nm = NEG, ni = NEG;  // vm', vi' of the last column walked
#pragma unroll
        for (int j = 0; j < C; ++j) {
            if (j < n) {
                const float om = vm[j], oi = vi[j], od = vd[j];
                nm = em[j] + op2<FORWARD>(
                                 op2<FORWARD>(pm + t_mm[j], pi + t_im[j]),
                                 op2<FORWARD>(pd + t_dm[j], entry));
                ni = op2<FORWARD>(om + t_mi[j], oi + t_ii[j]);
                if (FORWARD) {
                    const float d = nm - tot_m;
                    const float x = ex2(-fabsf(d));
                    tot_s = d > 0.0f ? fmaf(tot_s, x, 1.0f) : tot_s + x;
                }
                tot_m = fmaxf(tot_m, nm);
                vd[j] = S;  // S_{j-1}, applied in step 3
                sp = S;
                S = op2<FORWARD>(nm + t_md[j], S + t_dd[j]);
                vm[j] = nm;
                vi[j] = ni;
                pm = om;
                pi = oi;
                pd = od;
                em[j] = en[j];
            }
        }

        // 2. x_in: the maps (a_sum, S) of the threads before this one,
        //    composed in order ((A1, S1) then (A2, S2) is (A1 + A2,
        //    op(S2, S1 + A2))) and applied to NEG
        float A = a_sum;
#pragma unroll
        for (int d = 1; d < WARP; d <<= 1) {
            const float pa = __shfl_up_sync(FULL, A, d);
            const float ps = __shfl_up_sync(FULL, S, d);
            if (lane >= d) {
                S = op2<FORWARD>(S, ps + A);
                A += pa;
            }
        }
        float xs = __shfl_up_sync(FULL, S, 1);
        float xa = __shfl_up_sync(FULL, A, 1);
        if (lane == 0) {
            xs = NEG;
            xa = 0.0f;
        }
        float x_in = xs;
        if (W > 1) {
            // the one barrier a position: parity buffers keep a warp that
            // runs ahead from overwriting what a slower one still reads
            float(*x)[WS] = xch[i & 1];
            if (lane == WARP - 1) {
                x[0][warp] = A;
                x[1][warp] = S;
                x[2][warp] = nm;
                x[3][warp] = ni;
                x[4][warp] = xs;
                x[5][warp] = xa;
                x[6][warp] = sp;
                x[7][warp] = a_prev;
            }
            __syncthreads();
            // the warps' maps scanned over lanes < W, in order
            float wa = lane < W ? x[0][lane] : 0.0f;
            float ws = lane < W ? x[1][lane] : NEG;
#pragma unroll
            for (int d = 1; d < W; d <<= 1) {
                const float pa = __shfl_up_sync(FULL, wa, d);
                const float ps = __shfl_up_sync(FULL, ws, d);
                if (lane >= d) {
                    ws = op2<FORWARD>(ws, ps + wa);
                    wa += pa;
                }
            }
            const float before = __shfl_sync(FULL, ws, max(warp - 1, 0));
            const float before2 = __shfl_sync(FULL, ws, max(warp - 2, 0));
            if (warp > 0) {
                x_in = op2<FORWARD>(xs, before + xa);
                // the next position's feed: the previous warp's lane 31's
                // last column, its vd' as that lane computes it in step 3
                const int wp = warp - 1;
                float xp = x[4][wp];
                if (wp > 0) xp = op2<FORWARD>(xp, before2 + x[5][wp]);
                fm = x[2][wp];
                fi = x[3][wp];
                fd = ce > 1 ? op2<FORWARD>(x[6][wp], xp + x[7][wp]) : xp;
            }
        }

        // 3. vd'
        float lv = x_in;
#pragma unroll
        for (int j = 0; j < C; ++j) {
            if (j < n) {
                const float v =
                    j == 0 ? x_in
                           : op2<FORWARD>(vd[j], x_in + Ap[(j - 1) * T]);
                vd[j] = v;
                lv = v;
            }
        }
        lm = nm;
        li = ni;
        ld = lv;
    }

    // combine the threads' totals in a fixed order
    float m = tot_m;
    for (int d = WARP / 2; d > 0; d >>= 1)
        m = fmaxf(m, __shfl_xor_sync(FULL, m, d));
    float sum = 0.0f;
    if (FORWARD) {
        sum = tot_s * exp2f(tot_m - m);
        for (int d = WARP / 2; d > 0; d >>= 1)
            sum += __shfl_down_sync(FULL, sum, d);
    }
    if (W > 1) {
        if (lane == 0) {
            tots[0][warp] = m;
            tots[1][warp] = sum;
        }
        __syncthreads();
        if (t != 0) return;
        m = NEG;
        for (int w = 0; w < W; ++w) m = fmaxf(m, tots[0][w]);
        sum = 0.0f;
        if (FORWARD)
            for (int w = 0; w < W; ++w)
                sum += tots[1][w] * exp2f(tots[0][w] - m);
    } else if (lane != 0) {
        return;
    }
    if (FORWARD)
        out[pair] = sum > 0.0f ? m + log2f(sum) : NEG;
    else
        out[pair] = m;
}

template <bool FORWARD, int T, int C, int MINB>
static const void* kernel_of() {
    return (const void*)hmm_kernel<FORWARD, T, C, MINB>;
}

// The kernel for `threads` a pair at width mpad, its block and C; null
// if no configuration fits.
static const void* find_kernel(int threads, int mpad, int forward,
                               int* block, int* cols) {
    if (threads < 1 || mpad < 1) return nullptr;
    const int need = (mpad + threads - 1) / threads;
#define HMM_TRY(T_, C_, MINB_)                                       \
    if (threads == T_ && need <= C_) {                               \
        *block = Shape<T_>::BLOCK;                                   \
        *cols = C_;                                                  \
        return forward ? kernel_of<true, T_, C_, MINB_>()            \
                       : kernel_of<false, T_, C_, MINB_>();          \
    }
    HMM_CONFIGS(HMM_TRY)
#undef HMM_TRY
    return nullptr;
}

extern "C" {

int hmm_max_mpad(void) { return MAX_MPAD; }

// C, the columns a thread holds, of the kernel for `threads` a pair at
// width mpad; -1 if there is none.
int hmm_columns(int threads, int mpad) {
    int block, cols;
    return find_kernel(threads, mpad, 1, &block, &cols) ? cols : -1;
}

// Registers a thread, static shared memory a block, and resident warps an
// SM of that kernel (Forward: forward = 1, else Viterbi); a negative CUDA
// error, or -1 if there is no such kernel.
int hmm_num_regs(int threads, int mpad, int forward) {
    int block, cols;
    const void* fn = find_kernel(threads, mpad, forward, &block, &cols);
    if (!fn) return -1;
    cudaFuncAttributes at;
    cudaError_t err = cudaFuncGetAttributes(&at, fn);
    return err == cudaSuccess ? at.numRegs : -(int)err;
}

int hmm_smem_bytes(int threads, int mpad, int forward) {
    int block, cols;
    const void* fn = find_kernel(threads, mpad, forward, &block, &cols);
    if (!fn) return -1;
    cudaFuncAttributes at;
    cudaError_t err = cudaFuncGetAttributes(&at, fn);
    return err == cudaSuccess ? (int)at.sharedSizeBytes : -(int)err;
}

int hmm_warps_per_sm(int threads, int mpad, int forward) {
    int block, cols, blocks;
    const void* fn = find_kernel(threads, mpad, forward, &block, &cols);
    if (!fn) return -1;
    cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, block, 0);
    return err == cudaSuccess ? blocks * block / WARP : -(int)err;
}

// Raw bits (no null correction) of B pairs into out (B,) float32, `threads`
// a pair.  The walk pack: rec (H, slots, 8) and emit (H, 21, slots)
// float32 (ops/hmm_kernel.py::walk_pack, with the same threads and mpad),
// m_lens (H,) int32; codes (N, lmax) int8, lens (N,) int32, the index
// vectors (B,) int32.  Returns a CUDA error code, 0 on success.
int hmm_launch(const void* codes, int lmax, const void* lens,
               const void* rec, const void* emit, const void* m_lens,
               int mpad, int slots, const void* seq_idx,
               const void* hmm_idx, int B, int lpad, int threads,
               int forward, void* out, void* stream) {
    if (B < 1 || mpad < 1 || mpad > MAX_MPAD || lpad < 1 || lpad > lmax)
        return (int)cudaErrorInvalidValue;
    int block, cols;
    const void* fn = find_kernel(threads, mpad, forward, &block, &cols);
    if (!fn || slots != threads * ((mpad + threads - 1) / threads))
        return (int)cudaErrorInvalidValue;
    const long long groups = block / threads;
    const long long blocks = ((long long)B + groups - 1) / groups;
    void* args[] = {(void*)&codes, (void*)&lmax,    (void*)&lens,
                    (void*)&rec,   (void*)&emit,    (void*)&m_lens,
                    (void*)&mpad,  (void*)&slots,   (void*)&seq_idx,
                    (void*)&hmm_idx, (void*)&B,     (void*)&lpad,
                    (void*)&out};
    cudaError_t err = cudaLaunchKernel(fn, dim3((unsigned)blocks),
                                       dim3(block), args, 0,
                                       (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

const char* hmm_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
