// RWKV-6 WKV recurrence, chunk-parallel forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `wkv6_kernel` / `wkv6_chunked` in
// src/repro/kernels/rwkv6_scan.py.
//
// What it computes (the TPU kernel's contract): for every (batch, head),
// with w/r/k/v (B, S, H, 64) fp32, bonus u (H, 64) and state0 (B, H, 64, 64),
// chunk by chunk of C tokens (C = 32 or 64), with cw the inclusive
// in-chunk cumsum of log(max(w, 1e-38)), cw_prev = cw - log w, cw_last =
// cw[C-1]:
//   scores[t,j] = sum_i r[t,i] k[j,i] exp(cw_prev[t,i] - cw[j,i])   (j < t)
//   diag[t]     = sum_i r[t,i] u[i] k[t,i]
//   y           = scores @ v + diag * v + (r * exp(cw_prev)) @ S
//   S          <- exp(cw_last)^T * S + (k * exp(cw_last - cw))^T @ v
// and returns y (B, S, H, 64) and the last S (B, H, 64, 64), all fp32.
//
// Layout: w/r/k/v are read in the JAX layout (B, S, H, 64) through their
// own (batch, seq, head) element strides with a unit stride over the head
// dim; the TPU wrapper's fold to (B*H, S, 64) and unfold are never built.
// One block per (b, h) walks the chunks in order (the TPU grid's sequential
// axis), so the 64x64 fp32 state stays in shared memory from state0 to the
// last chunk. Starting from state0 replaces the TPU wrapper's fold of
// state0 by linearity with a global log-cumsum over the whole sequence.
//
// What bounds it on this card: at the served shape (B=1, S=448, H=64) the
// function moves ~39 MB (11.6 us at 3.35 TB/s), does ~0.84 GFLOP of fp32
// (12.5 us at 67 TFLOP/s) and ~62M exp (about 15 us at 16 per SM per
// clock, 132 SMs, 1.98 GHz): the exp of the intra-chunk triangle,
// C(C-1)/2 x 64 per chunk, sets the bound. What the design does about
// it: each exp is computed once, on the fly, for the strict lower triangle only, so the (C, C, 64)
// log-difference tensor (1 MB per chunk at C = 64) is never stored; the
// per-chunk tiles (r, k, v, cw, cw_prev: 5 x C x 65 floats), the state and
// the scores stay in ~114 KB of dynamic shared memory; rows are padded to
// 65 floats so the column walks over j are conflict-free. All math is fp32
// on the CUDA cores (TF32 would miss the reference's 5e-4). The build keeps
// denormals (no -use_fast_math, no -ftz): 1e-38 is below FLT_MIN, and
// flushed to zero its log would be -inf and the score exponent NaN.
// Known limit: B*H blocks (64 at B=1) on 132 SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HS = 64;        // head size
constexpr int LD = HS + 1;    // padded tile row
constexpr int THREADS = 256;  // 4 rows x 64 columns in the y and state passes

struct Strides {
    int64_t b[4], s[4], h[4];  // w, r, k, v: (batch, seq, head) element strides
};

template <int C>
__global__ void __launch_bounds__(THREADS)
wkv6_fwd_kernel(const float* __restrict__ w, const float* __restrict__ r,
                const float* __restrict__ k, const float* __restrict__ v,
                const float* __restrict__ u, const float* __restrict__ s0,
                float* __restrict__ y, float* __restrict__ s_out,
                int S, int H, Strides st) {
    extern __shared__ float smem[];
    float* cw = smem;               // [C][LD] inclusive log-decay cumsum
    float* cwp = cw + C * LD;       // [C][LD] log w, then cw - log w
    float* rs = cwp + C * LD;       // [C][LD] r, then r * e^{cw_prev}
    float* ks = rs + C * LD;        // [C][LD] k, then k * e^{cw_last - cw}
    float* vs = ks + C * LD;        // [C][LD] v
    float* Ss = vs + C * LD;        // [HS][HS] state
    float* sc = Ss + HS * HS;       // [C][C] scores, zero on and above the diagonal
    float* dg = sc + C * C;         // [C] bonus diagonal
    float* us = dg + C;             // [HS] bonus u
    float* ecl = us + HS;           // [HS] e^{cw_last}

    const int tid = threadIdx.x;
    const int bh = blockIdx.x;
    const int b = bh / H, h = bh % H;
    const int jx = tid % HS;        // column owned in the y and state passes
    const int ty = tid / HS;        // rows ty, ty + 4, ...

    const float* wb = w + b * st.b[0] + h * st.h[0];
    const float* rb = r + b * st.b[1] + h * st.h[1];
    const float* kb = k + b * st.b[2] + h * st.h[2];
    const float* vb = v + b * st.b[3] + h * st.h[3];

    for (int i = tid; i < HS * HS; i += THREADS) Ss[i] = s0[(int64_t)bh * HS * HS + i];
    if (tid < HS) us[tid] = u[h * HS + tid];

    for (int t0 = 0; t0 < S; t0 += C) {
        __syncthreads();  // the previous chunk's readers are done (and Ss, us are loaded)
        for (int idx = tid; idx < C * HS; idx += THREADS) {
            const int t = idx / HS, i = idx % HS;
            const int64_t tt = t0 + t;
            cwp[t * LD + i] = logf(fmaxf(wb[tt * st.s[0] + i], 1e-38f));
            rs[t * LD + i] = rb[tt * st.s[1] + i];
            ks[t * LD + i] = kb[tt * st.s[2] + i];
            vs[t * LD + i] = vb[tt * st.s[3] + i];
        }
        __syncthreads();
        if (tid < HS) {
            float acc = 0.f;
            for (int t = 0; t < C; ++t) {
                acc += cwp[t * LD + tid];
                cw[t * LD + tid] = acc;
            }
            ecl[tid] = expf(acc);
        }
        __syncthreads();
        for (int idx = tid; idx < C * HS; idx += THREADS) {
            const int t = idx / HS, i = idx % HS;
            cwp[t * LD + i] = cw[t * LD + i] - cwp[t * LD + i];
        }
        __syncthreads();

        // intra-chunk scores over the strict lower triangle: the mask is
        // applied before the exponent is formed, so cw_prev - cw is only
        // ever taken where it is <= 0
        for (int idx = tid; idx < C * C; idx += THREADS) {
            const int t = idx / C, j = idx % C;
            float s = 0.f;
            if (j < t) {
                const float* rt = rs + t * LD;
                const float* pt = cwp + t * LD;
                const float* kj = ks + j * LD;
                const float* cj = cw + j * LD;
#pragma unroll 8
                for (int i = 0; i < HS; ++i) s = fmaf(rt[i] * kj[i], expf(pt[i] - cj[i]), s);
            }
            sc[t * C + j] = s;
        }
        if (tid < C) {
            float d = 0.f;
            for (int i = 0; i < HS; ++i) d = fmaf(rs[tid * LD + i] * us[i], ks[tid * LD + i], d);
            dg[tid] = d;
        }
        __syncthreads();
        for (int idx = tid; idx < C * HS; idx += THREADS) {
            const int t = idx / HS, i = idx % HS;
            rs[t * LD + i] *= expf(cwp[t * LD + i]);
            ks[t * LD + i] *= expf(cw[(C - 1) * LD + i] - cw[t * LD + i]);
        }
        __syncthreads();

        // y = scores @ v + (r * e^{cw_prev}) @ S + diag * v
        float acc[C / 4];
#pragma unroll
        for (int q = 0; q < C / 4; ++q) acc[q] = 0.f;
        for (int s = 0; s < C; ++s) {
            const float vv = vs[s * LD + jx];
#pragma unroll
            for (int q = 0; q < C / 4; ++q) acc[q] = fmaf(sc[(ty + 4 * q) * C + s], vv, acc[q]);
        }
        for (int i = 0; i < HS; ++i) {
            const float sv = Ss[i * HS + jx];
#pragma unroll
            for (int q = 0; q < C / 4; ++q) acc[q] = fmaf(rs[(ty + 4 * q) * LD + i], sv, acc[q]);
        }
#pragma unroll
        for (int q = 0; q < C / 4; ++q) {
            const int t = ty + 4 * q;
            y[(((int64_t)b * S + t0 + t) * H + h) * HS + jx] = fmaf(dg[t], vs[t * LD + jx], acc[q]);
        }
        __syncthreads();  // every reader of the old state is done

        // S = e^{cw_last}^T * S + (k * e^{cw_last - cw})^T @ v
        float sa[HS / 4];
#pragma unroll
        for (int q = 0; q < HS / 4; ++q) {
            const int i = ty + 4 * q;
            sa[q] = ecl[i] * Ss[i * HS + jx];
        }
        for (int t = 0; t < C; ++t) {
            const float vv = vs[t * LD + jx];
#pragma unroll
            for (int q = 0; q < HS / 4; ++q) sa[q] = fmaf(ks[t * LD + ty + 4 * q], vv, sa[q]);
        }
#pragma unroll
        for (int q = 0; q < HS / 4; ++q) Ss[(ty + 4 * q) * HS + jx] = sa[q];
    }
    __syncthreads();
    for (int i = tid; i < HS * HS; i += THREADS) s_out[(int64_t)bh * HS * HS + i] = Ss[i];
}

template <int C>
int launch(const float* w, const float* r, const float* k, const float* v, const float* u,
           const float* s0, float* y, float* s_out, int B, int S, int H, const Strides& st,
           cudaStream_t stream) {
    const size_t smem = (size_t)(5 * C * LD + HS * HS + C * C + C + 2 * HS) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(wkv6_fwd_kernel<C>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    wkv6_fwd_kernel<C><<<B * H, THREADS, smem, stream>>>(w, r, k, v, u, s0, y, s_out, S, H, st);
    return (int)cudaGetLastError();
}

}  // namespace

// w/r/k/v (B, S, H, 64) fp32 through `strides` = 12 element strides, the
// (batch, seq, head) strides of w, r, k and v in that order, unit stride
// over the head dim; u (H, 64), state0 (B, H, 64, 64), y (B, S, H, 64) and
// s_out (B, H, 64, 64) contiguous fp32. S must be a multiple of chunk, and
// chunk 32 or 64. Returns a cudaError_t (0 = launched).
extern "C" int repro_wkv6_fwd(const void* w, const void* r, const void* k, const void* v,
                              const void* u, const void* state0, void* y, void* s_out,
                              int B, int S, int H, int hs, int chunk, const int64_t* strides,
                              void* stream) {
    if (hs != HS || B <= 0 || H <= 0 || S <= 0 || S % chunk != 0) return (int)cudaErrorInvalidValue;
    Strides st;
    for (int a = 0; a < 4; ++a) {
        st.b[a] = strides[3 * a];
        st.s[a] = strides[3 * a + 1];
        st.h[a] = strides[3 * a + 2];
    }
    cudaStream_t cs = (cudaStream_t)stream;
    const float *wf = (const float*)w, *rf = (const float*)r, *kf = (const float*)k, *vf = (const float*)v;
    if (chunk == 64)
        return launch<64>(wf, rf, kf, vf, (const float*)u, (const float*)state0, (float*)y, (float*)s_out, B, S, H, st, cs);
    if (chunk == 32)
        return launch<32>(wf, rf, kf, vf, (const float*)u, (const float*)state0, (float*)y, (float*)s_out, B, S, H, st, cs);
    return (int)cudaErrorInvalidValue;
}
