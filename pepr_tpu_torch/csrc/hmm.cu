// Plan7 local Forward / Viterbi scoring of (sequence, profile) pairs on
// Hopper.
//
// Not a port of a TPU kernel: the JAX package scores with an XLA
// lax.scan (pepr_tpu/ops/hmm.py:206 viterbi_segment, driven by
// profile_score_pairs).  Its plain PyTorch version is
// ops/hmm.py::viterbi_score_batch, which follows that scan step for
// step; this kernel computes the same function and is held against it
// within a stated tolerance (sums in another order).
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
// every state starts at the sentinel NEG = -1e30, and at k = 0 the
// shifted terms are NEG + NEG, as in the reference (logaddexp2 of two
// such finite sentinels is finite: no -inf, so no NaN from inf - inf).
// The reference walks the padded rectangle under a live mask and a
// k < M mask; cells outside L x M never feed a real cell and add
// exactly 0 (Forward) or nothing (Viterbi) to the total, so the kernel
// walks the real cells only.  Returns the raw total; the wrapper
// subtracts the null correction.
//
// Design.  One warp scores one pair; four warps a block, no block
// barrier.  Lane l owns C = ceil(M / 32) consecutive match states
// [l C, l C + C) and keeps their vm, vi, vd in shared memory, stored
// column-major over lanes (state j of lane l at j * 32 + l) so that a
// warp's accesses never conflict on a bank; a lane touches only its own
// words.  Per sequence position:
//   1. each lane gets the previous lane's last state (the k - 1 feed of
//      its first column) by __shfl_up_sync, then walks its columns left
//      to right: vm' and vi' from the previous row, and the delete
//      chain's affine maps f_k(x) = op(s_k, x + a_k), s_k = vm'[k-1] +
//      tmd[k-1], a_k = tdd[k-1], composed serially ((a1, s1) then
//      (a2, s2) is (a1 + a2, op(s2, s1 + a2)));
//   2. a 5-step Kogge-Stone scan of the lanes' composed maps by
//      __shfl_up_sync gives each lane the chain's value entering its
//      first column;
//   3. each lane walks its columns again and writes vd'.
// Forward's total is one online log-sum-exp2 a lane over all its cells
// (a running max and a sum of exp2), Viterbi's a running max, combined
// over the warp at the end.  A pair's score depends only on the pair:
// the batch and its order change nothing (the enhancer compares scores
// with ==).
//
// What bounds it on this card: the special-function unit.  Forward
// needs, a real cell, five logaddexp2s (three for vm', one for vi', one
// for vd'), each an exp2 and a log, and one exp2 for the total: 11 MUFU
// operations (chip_smoke.py's HMM_MUFU_PER_CELL), at 16 a clock on each
// of the 132 SMs.  This design spends a sixth logaddexp2 a cell on
// composing the delete chain's maps (step 1), work of the lane-parallel
// scan and not of the function, so the bound leaves it out.  Bytes do
// not bind: the packs are read from L2 (a profile's rows are reused by
// every position of its sequences).  This first design reads the
// transitions and emissions of a lane's columns with strided loads (a
// lane's columns are contiguous, so a warp's 32 loads touch 32 lines)
// and computes logaddexp2 as log1p(exp2(-|d|)) like the reference, not
// with the approximate MUFU forms; both are left for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

#define WARP 32
#define WARPS_PER_BLOCK 4
#define N_AA 20
#define MAX_MPAD 4096

static constexpr float NEG = -1e30f;
// float32(1 / ln 2), as jnp.logaddexp2 multiplies
static constexpr float INV_LN2 = 1.44269504088896340736f;
static constexpr unsigned FULL = 0xffffffffu;

template <bool FORWARD>
__device__ __forceinline__ float op2(float a, float b) {
    if (FORWARD) {
        return fmaxf(a, b) + INV_LN2 * log1pf(exp2f(-fabsf(a - b)));
    } else {
        return fmaxf(a, b);
    }
}

// shared memory of one warp: vm, vi, vd of 32 * cmax states each
static __host__ __device__ inline int cmax_of(int mpad) {
    return (mpad + WARP - 1) / WARP;
}

static inline size_t smem_bytes(int mpad) {
    return (size_t)WARPS_PER_BLOCK * 3 * WARP * cmax_of(mpad) *
           sizeof(float);
}

template <bool FORWARD>
__global__ void __launch_bounds__(WARP * WARPS_PER_BLOCK)
hmm_kernel(const int8_t* __restrict__ codes, int lmax,
           const int* __restrict__ lens, const float* __restrict__ emit,
           const float* __restrict__ tmm, const float* __restrict__ tmi,
           const float* __restrict__ tmd, const float* __restrict__ tim,
           const float* __restrict__ tii, const float* __restrict__ tdm,
           const float* __restrict__ tdd, const int* __restrict__ m_lens,
           int mpad, const int* __restrict__ seq_idx,
           const int* __restrict__ hmm_idx, int B, int lpad,
           float* __restrict__ out) {
    extern __shared__ float smem[];
    const int lane = threadIdx.x & (WARP - 1);
    const int warp = threadIdx.x / WARP;
    const long long pair = (long long)blockIdx.x * WARPS_PER_BLOCK + warp;
    if (pair >= B) return;  // the whole warp: no block barrier follows
    const int cmax = cmax_of(mpad);
    float* vm = smem + (size_t)warp * 3 * WARP * cmax;
    float* vi = vm + WARP * cmax;
    float* vd = vi + WARP * cmax;

    const int s = seq_idx[pair];
    const int h = hmm_idx[pair];
    const int L = min(lens[s], lpad);
    const int M = min(m_lens[h], mpad);
    const float entry = -log2f(fmaxf((float)M, 1.0f));
    const int C = (M + WARP - 1) / WARP;
    const int k0 = lane * C;
    const int n = max(0, min(C, M - k0));  // this lane's columns

    const int8_t* seq = codes + (long long)s * lmax;
    const float* em = emit + (long long)h * N_AA * mpad;
    const long long tro = (long long)h * (mpad + 1);
    const float* Tmm = tmm + tro;
    const float* Tmi = tmi + tro;
    const float* Tmd = tmd + tro;
    const float* Tim = tim + tro;
    const float* Tii = tii + tro;
    const float* Tdm = tdm + tro;
    const float* Tdd = tdd + tro;

    for (int j = 0; j < n; ++j) {
        vm[j * WARP + lane] = NEG;
        vi[j * WARP + lane] = NEG;
        vd[j * WARP + lane] = NEG;
    }
    // running total: Forward keeps (tot_m, tot_s) with the lane's
    // log-sum-exp2 = tot_m + log2(tot_s); Viterbi keeps the max in tot_m
    float tot_m = NEG, tot_s = 0.0f;

    for (int i = 0; i < L; ++i) {
        const int c = seq[i];
        const bool emits = c >= 0 && c < N_AA;
        const float* erow = em + (emits ? c : 0) * mpad;

        // the previous row's states at column k0 - 1, from the lane
        // before (lane 0: the NEG of the reference's shift)
        float lm = NEG, li = NEG, ld = NEG;
        if (n > 0) {
            const int t = (n - 1) * WARP + lane;
            lm = vm[t];
            li = vi[t];
            ld = vd[t];
        }
        float pm = __shfl_up_sync(FULL, lm, 1);
        float pi = __shfl_up_sync(FULL, li, 1);
        float pd = __shfl_up_sync(FULL, ld, 1);
        if (lane == 0) pm = pi = pd = NEG;

        // 1. vm', vi', and the composition of the chain's maps of
        //    columns k0 + 1 .. k0 + n - 1
        float A = 0.0f, S = NEG;  // the identity map
        float prev_new = NEG;     // vm' of the column before
        for (int j = 0; j < n; ++j) {
            const int k = k0 + j;
            const int t = j * WARP + lane;
            const float om = vm[t], oi = vi[t], od = vd[t];
            float t_mm = NEG, t_im = NEG, t_dm = NEG;
            if (k > 0) {
                t_mm = __ldg(Tmm + k - 1);
                t_im = __ldg(Tim + k - 1);
                t_dm = __ldg(Tdm + k - 1);
            }
            const float best = op2<FORWARD>(
                op2<FORWARD>(pm + t_mm, pi + t_im),
                op2<FORWARD>(pd + t_dm, entry));
            const float e = emits ? __ldg(erow + k) : 0.0f;
            const float nvm = e + best;
            const float nvi = op2<FORWARD>(om + __ldg(Tmi + k),
                                           oi + __ldg(Tii + k));
            vm[t] = nvm;
            vi[t] = nvi;
            if (FORWARD) {
                if (nvm > tot_m) {
                    tot_s = tot_s * exp2f(tot_m - nvm) + 1.0f;
                    tot_m = nvm;
                } else {
                    tot_s += exp2f(nvm - tot_m);
                }
            } else {
                tot_m = fmaxf(tot_m, nvm);
            }
            if (j > 0) {
                const float a = __ldg(Tdd + k - 1);
                const float sk = prev_new + __ldg(Tmd + k - 1);
                S = op2<FORWARD>(sk, S + a);
                A = A + a;
            }
            prev_new = nvm;
            pm = om;
            pi = oi;
            pd = od;
        }
        // the first column's map needs vm' of column k0 - 1
        const float before = __shfl_up_sync(FULL, prev_new, 1);
        float a0 = NEG, s0 = NEG;  // k = 0: the reference's shifted NEGs
        if (k0 > 0 && n > 0) {
            a0 = __ldg(Tdd + k0 - 1);
            s0 = before + __ldg(Tmd + k0 - 1);
        }
        if (n > 0) {  // f_{k0} first, then the rest
            S = op2<FORWARD>(S, s0 + A);
            A = a0 + A;
        }

        // 2. inclusive scan of the lanes' maps, then the chain's value
        //    entering this lane (lane 0: x_{-1}, the sentinel)
        for (int d = 1; d < WARP; d <<= 1) {
            const float Ap = __shfl_up_sync(FULL, A, d);
            const float Sp = __shfl_up_sync(FULL, S, d);
            if (lane >= d) {
                S = op2<FORWARD>(S, Sp + A);
                A = Ap + A;
            }
        }
        float x = __shfl_up_sync(FULL, S, 1);
        if (lane == 0) x = NEG;

        // 3. the chain through this lane's columns
        float pv = before;
        for (int j = 0; j < n; ++j) {
            const int k = k0 + j;
            const int t = j * WARP + lane;
            float a = NEG, sk = NEG;
            if (k > 0) {
                a = __ldg(Tdd + k - 1);
                sk = pv + __ldg(Tmd + k - 1);
            }
            x = op2<FORWARD>(sk, x + a);
            vd[t] = x;
            pv = vm[t];
        }
    }

    // combine the lanes' totals in a fixed order
    if (FORWARD) {
        float m = tot_m;
        for (int d = WARP / 2; d > 0; d >>= 1)
            m = fmaxf(m, __shfl_xor_sync(FULL, m, d));
        float sum = tot_s * exp2f(tot_m - m);
        for (int d = WARP / 2; d > 0; d >>= 1)
            sum += __shfl_down_sync(FULL, sum, d);
        if (lane == 0) out[pair] = sum > 0.0f ? m + log2f(sum) : NEG;
    } else {
        float m = tot_m;
        for (int d = WARP / 2; d > 0; d >>= 1)
            m = fmaxf(m, __shfl_down_sync(FULL, m, d));
        if (lane == 0) out[pair] = m;
    }
}

template <bool FORWARD>
static cudaError_t launch(const int8_t* codes, int lmax, const int* lens,
                          const float* emit, const float* const* tr,
                          const int* m_lens, int mpad, const int* seq_idx,
                          const int* hmm_idx, int B, int lpad, float* out,
                          cudaStream_t stream) {
    const size_t smem = smem_bytes(mpad);
    cudaError_t err = cudaFuncSetAttribute(
        hmm_kernel<FORWARD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    const long long blocks = ((long long)B + WARPS_PER_BLOCK - 1) /
                             WARPS_PER_BLOCK;
    hmm_kernel<FORWARD><<<(unsigned)blocks, WARP * WARPS_PER_BLOCK, smem,
                          stream>>>(
        codes, lmax, lens, emit, tr[0], tr[1], tr[2], tr[3], tr[4], tr[5],
        tr[6], m_lens, mpad, seq_idx, hmm_idx, B, lpad, out);
    return cudaGetLastError();
}

extern "C" {

int hmm_max_mpad(void) { return MAX_MPAD; }

int hmm_warps_per_block(void) { return WARPS_PER_BLOCK; }

long long hmm_smem_bytes(int mpad) { return (long long)smem_bytes(mpad); }

// Registers per thread of the Forward (forward = 1) or Viterbi kernel,
// or a negative CUDA error.
int hmm_num_regs(int forward) {
    cudaFuncAttributes at;
    cudaError_t err = forward
                          ? cudaFuncGetAttributes(&at, hmm_kernel<true>)
                          : cudaFuncGetAttributes(&at, hmm_kernel<false>);
    return err == cudaSuccess ? at.numRegs : -(int)err;
}

// Raw bits (no null correction) of B pairs into out (B,) float32.  The
// transitions are tmm, tmi, tmd, tim, tii, tdm, tdd, each (H, mpad + 1);
// emit is (H, 20, mpad); codes (N, lmax) int8.  Returns a CUDA error
// code, 0 on success.
int hmm_launch(const void* codes, int lmax, const void* lens,
               const void* emit, const void* tmm, const void* tmi,
               const void* tmd, const void* tim, const void* tii,
               const void* tdm, const void* tdd, const void* m_lens,
               int mpad, const void* seq_idx, const void* hmm_idx, int B,
               int lpad, int forward, void* out, void* stream) {
    if (B < 1 || mpad < 1 || mpad > MAX_MPAD || lpad < 1 || lpad > lmax)
        return (int)cudaErrorInvalidValue;
    const float* tr[7] = {(const float*)tmm, (const float*)tmi,
                          (const float*)tmd, (const float*)tim,
                          (const float*)tii, (const float*)tdm,
                          (const float*)tdd};
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err =
        forward ? launch<true>((const int8_t*)codes, lmax, (const int*)lens,
                               (const float*)emit, tr, (const int*)m_lens,
                               mpad, (const int*)seq_idx,
                               (const int*)hmm_idx, B, lpad, (float*)out, st)
                : launch<false>((const int8_t*)codes, lmax, (const int*)lens,
                                (const float*)emit, tr, (const int*)m_lens,
                                mpad, (const int*)seq_idx,
                                (const int*)hmm_idx, B, lpad, (float*)out,
                                st);
    return (int)err;
}

const char* hmm_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
