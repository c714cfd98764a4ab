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
//
// What bounds it on this card: at the served shape (B=1, S=448, H=64,
// C=64) the function moves ~39 MB (11.6 us at 3.35 TB/s), does ~0.84 GFLOP
// of fp32 (12.5 us at 67 TFLOP/s) and ~62M exp (about 15 us at 16 per SM per
// clock, 132 SMs, 1.98 GHz): the exp of the intra-chunk triangle,
// C(C-1)/2 x 64 per chunk, sets the bound. What the design does about it:
//   - Only the state carry is sequential, so the work is spread over one
//     block per (batch, head, chunk): 448 blocks at the served shape, all
//     resident at once (four per SM: ~51 KB of shared memory and at most 64
//     registers each at C = 64).
//   - Pass 1 (`wkv6_intra_kernel`) does everything that needs only its own
//     chunk: the log-cumsum as a warp-shuffle scan (in log2 units), the
//     strict lower-triangle scores with the bonus diagonal, y's intra-chunk
//     part, the chunk's state increment U_c = (k * 2^{cw_last - cw})^T v,
//     the row decay 2^{cw_last}, and r * 2^{cw_prev} for pass 2. cw is kept
//     once, with a zero row for token -1, so cw_prev[t] is the row cw[t-1]
//     (the same value as cw[t] - log w[t], one rounding fewer).
//   - The triangle enumerates j < t only: the 4x4 blocks strictly below the
//     diagonal as 2x4 register tiles (8 independent sums per thread, 12
//     loads for 8 terms, 240 threads at C = 64), and the 96 pairs inside
//     the 16 diagonal blocks on six other whole warps, so no warp runs both
//     paths. Each term is one `ex2.approx.f32` (no .ftz: subnormals kept)
//     of its own non-positive log2 difference: exp(cw_prev[t] - cw[j]) is
//     never factored into per-token factors, which overflow or underflow
//     fp32 under strong decay. The triangle runs at about the SFU's rate.
//   - Pass 2 (`wkv6_inter_kernel`, 128 threads per block, all resident)
//     carries the state to its chunk, S_{c-1} = 2^{cw_last,c-1} * S_{c-2} +
//     U_{c-1} from state0 (the loads of U_{m+1} in flight while U_m is
//     applied), adds (r * 2^{cw_prev}) @ S_{c-1} into y, and the last
//     chunk's block writes the last state. The longest carries start first.
//   - What holds it back now: the blocks run their phases in lockstep, so
//     the loads of w, r, k at the start (DRAM-bound), the triangle
//     (SFU-bound) and the products (FMA-bound) do not overlap; a persistent
//     kernel that prefetches its next chunk would.
// All math is fp32 on the CUDA cores (TF32 would miss the reference's
// 5e-4). log2f of max(w, 1e-38) is exact to an ulp; 1e-38 is below FLT_MIN,
// so the build keeps denormals (no -use_fast_math, no -ftz): flushed to zero
// its log would be -inf and the score exponent NaN.
// ptxas (CUDA 12.8, sm_90a): pass 1 64 registers and 16 bytes of spill at
// C = 64, 63 registers at C = 32; pass 2 100 and 98 registers; no other
// spills.
// Known limit: chunk 32 leaves about 100 of the 256 threads idle in the
// triangle (no served path uses it).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HS = 64;        // head size
constexpr int LD = HS + 1;    // padded row of a [token][channel] tile
constexpr int LDV = HS + 4;   // row of a tile read as float4
constexpr int THREADS = 256;

struct Strides {
    int64_t b[4], s[4], h[4];  // w, r, k, v: (batch, seq, head) element strides
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_u32(dst)), "l"(src), "n"(BYTES));
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}


__device__ __forceinline__ float4 decay_add(float e, float4 s, float4 u) {  // e * s + u
    return make_float4(fmaf(e, s.x, u.x), fmaf(e, s.y, u.y), fmaf(e, s.z, u.z), fmaf(e, s.w, u.w));
}

// 2^x as one MUFU.EX2, subnormal results kept (no .ftz)
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}


template <int C>
constexpr size_t intra_smem_bytes() {
    // R, K: [C][LD]; W: [C+1][LD] (row 0 zero: cw of token -1); dg [C], us [HS], cwl [HS].
    // After the triangle R holds the scores [C][C+1], and W then v [C][HS].
    return (size_t)((3 * C + 1) * LD + C + 2 * HS) * sizeof(float);
}

// One block per (chunk, head, batch), four per SM. Writes y's intra-chunk
// part, the chunk's state increment U (B, H, nc, 64, 64), its row decay ecl
// (B, H, nc, 64) and rdec = r * 2^{cw_prev}, transposed per chunk
// (B, H, nc, 64, C).
template <int C>
__global__ void __launch_bounds__(THREADS, 4)
wkv6_intra_kernel(const float* __restrict__ w, const float* __restrict__ r,
                  const float* __restrict__ k, const float* __restrict__ v,
                  const float* __restrict__ u, float* __restrict__ y,
                  float* __restrict__ U, float* __restrict__ ecl, float* __restrict__ rdec,
                  int S, int H, Strides st) {
    extern __shared__ float smem[];
    float* R = smem;                  // [C][LD] r; then the scores [C][C+1]
    float* K = R + C * LD;            // [C][LD] k; then k * 2^{cw_last - cw}
    float* W = K + C * LD;            // [C+1][LD] cw[t-1] at row t: cw_prev[t] = W[t], cw[t] = W[t+1]; then v [C][HS]
    float* dg = W + (C + 1) * LD;     // [C] bonus diagonal
    float* us = dg + C;               // [HS] bonus u
    float* cwl = us + HS;             // [HS] cw_last
    float* sc = R;
    float* vs = W;                    // 16-byte aligned: (2 C LD) floats in

    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int nc = gridDim.x;
    const int t0 = c * C;
    const int64_t bh = (int64_t)b * H + h;

    const float* wb = w + b * st.b[0] + h * st.h[0] + (int64_t)t0 * st.s[0];
    const float* rb = r + b * st.b[1] + h * st.h[1] + (int64_t)t0 * st.s[1];
    const float* kb = k + b * st.b[2] + h * st.h[2] + (int64_t)t0 * st.s[2];
    const float* vb = v + b * st.b[3] + h * st.h[3] + (int64_t)t0 * st.s[3];


    // A: the chunk's w (into the rows where its cumsum will go), r and k,
    // every copy in flight at once
#pragma unroll 4
    for (int m = 0; m < C * HS / THREADS; ++m) {
        const int idx = tid + m * THREADS;
        const int t = idx / HS, i = idx % HS;
        cp_async<4>(W + (t + 1) * LD + i, wb + t * st.s[0] + i);
        cp_async<4>(R + t * LD + i, rb + t * st.s[1] + i);
        cp_async<4>(K + t * LD + i, kb + t * st.s[2] + i);
    }
    if (tid < HS) {
        us[tid] = u[h * HS + tid];
        W[tid] = 0.f;
    }
    cp_async_wait_all();
    __syncthreads();

    // B: log2 of the decay and its inclusive cumsum over the chunk, a
    // warp-shuffle scan per channel, lanes over tokens (lane, lane + 32)
    constexpr int NT = C / 32;  // tokens per lane
    for (int i = warp; i < HS; i += THREADS / 32) {
        float x[NT];
#pragma unroll
        for (int n = 0; n < NT; ++n) x[n] = log2f(fmaxf(W[(lane + 32 * n + 1) * LD + i], 1e-38f));
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
            for (int n = 0; n < NT; ++n) {
                const float yv = __shfl_up_sync(0xffffffffu, x[n], off);
                if (lane >= off) x[n] += yv;
            }
        }
#pragma unroll
        for (int n = 1; n < NT; ++n) x[n] += __shfl_sync(0xffffffffu, x[n - 1], 31);
#pragma unroll
        for (int n = 0; n < NT; ++n) W[(lane + 32 * n + 1) * LD + i] = x[n];
        const float last = __shfl_sync(0xffffffffu, x[NT - 1], 31);
        if (lane == 0) {
            cwl[i] = last;
            ecl[(bh * nc + c) * HS + i] = ex2(last);
        }
    }
    __syncthreads();

    // C1: r * 2^{cw_prev} for pass 2, channel-major, and the bonus diagonal
#pragma unroll 4
    for (int m = 0; m < C * HS / THREADS; ++m) {
        const int idx = tid + m * THREADS;
        const int i = idx / C, t = idx % C;
        rdec[((bh * nc + c) * HS + i) * C + t] = R[t * LD + i] * ex2(W[t * LD + i]);
    }
    {
        constexpr int TPR = THREADS / C;  // threads per token
        const int t = tid / TPR, part = tid % TPR;
        float d = 0.f;
        for (int i = part; i < HS; i += TPR) d = fmaf(R[t * LD + i] * us[i], K[t * LD + i], d);
#pragma unroll
        for (int off = TPR / 2; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
        if (part == 0) dg[t] = d;
    }

    // C2a: the pairs inside the diagonal 4x4 blocks, (1,0) (2,0) (2,1)
    // (3,0) (3,1) (3,2) of each, two threads per pair (halves of i) on
    // whole warps, so that no warp mixes them with C2b's tiles
    constexpr int NB = C / 4;
    constexpr int N_OFF = NB * (NB - 1) / 2;
    float dsum = 0.f;
    int dt = 0, dj = 0;
    if (tid < 2 * 6 * NB) {
        const int p = tid >> 1, q = p % 6, d0 = 4 * (p / 6);
        const int dr = q < 1 ? 1 : q < 3 ? 2 : 3;
        dt = d0 + dr;
        dj = d0 + q - (dr - 1) * dr / 2;
#pragma unroll 8
        for (int i = 32 * (tid & 1); i < 32 * (tid & 1) + 32; ++i)
            dsum = fmaf(R[dt * LD + i] * K[dj * LD + i], ex2(W[dt * LD + i] - W[(dj + 1) * LD + i]), dsum);
    }
    dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);

    // C2b: the 4x4 blocks strictly below the diagonal (TB > JB), each as two
    // 2x4 register tiles, 8 independent sums per thread held in registers
    // until R is free
    float acc[2][4] = {};
    int ta = 0, jb = 0;
    if (tid < 2 * N_OFF) {
        const int blk = tid >> 1, hf = tid & 1;
        int TB = (int)((1.f + sqrtf(8.f * blk + 1.f)) * 0.5f);
        while (TB * (TB - 1) / 2 > blk) --TB;
        while (TB * (TB + 1) / 2 <= blk) ++TB;
        const int JB = blk - TB * (TB - 1) / 2;
        ta = 4 * TB + 2 * hf;
        jb = 4 * JB;
        const float* ra = R + ta * LD;   // rows ta, ta + 1
        const float* pa = W + ta * LD;   // cw_prev of rows ta, ta + 1
        const float* kb4 = K + jb * LD;  // rows jb .. jb + 3
        const float* cb = W + (jb + 1) * LD;  // cw of rows jb .. jb + 3
#pragma unroll 2
        for (int i = 0; i < HS; ++i) {
            const float r0 = ra[i], r1 = ra[LD + i], p0 = pa[i], p1 = pa[LD + i];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
                const float kj = kb4[jj * LD + i], cj = cb[jj * LD + i];
                acc[0][jj] = fmaf(r0 * kj, ex2(p0 - cj), acc[0][jj]);
                acc[1][jj] = fmaf(r1 * kj, ex2(p1 - cj), acc[1][jj]);
            }
        }
    }
    __syncthreads();  // R is read: it becomes the scores

    // D0: the scores out of registers, and k * 2^{cw_last - cw} in place
    if (tid < 2 * N_OFF) {
#pragma unroll
        for (int ti = 0; ti < 2; ++ti)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) sc[(ta + ti) * (C + 1) + jb + jj] = acc[ti][jj];
    }
    if (tid < 2 * 6 * NB && (tid & 1) == 0) sc[dt * (C + 1) + dj] = dsum;
#pragma unroll 4
    for (int m = 0; m < C * HS / THREADS; ++m) {
        const int idx = tid + m * THREADS;
        const int t = idx / HS, i = idx % HS;
        K[t * LD + i] *= ex2(cwl[i] - W[(t + 1) * LD + i]);
    }
    __syncthreads();  // W is read: it becomes v
#pragma unroll 4
    for (int m = 0; m < C * HS / THREADS; ++m) {
        const int idx = tid + m * THREADS;
        const int t = idx / HS, i = idx % HS;
        cp_async<4>(vs + t * HS + i, vb + t * st.s[3] + i);  // any strides: 4-byte copies
    }
    cp_async_wait_all();
    __syncthreads();

    // D: y_intra[t, :] = sum_{s<t} sc[t,s] v[s, :] + dg[t] v[t, :] and
    // U[i, :] = sum_s krem[s,i] v[s, :], sharing each row of v; the y rows
    // t = tr + 16a take only the segments of s below them
    {
        constexpr int RA = C / 16;  // y rows per thread
        const int tr = tid / 16, tc = tid % 16;
        float4 ya[RA], ua[4];
#pragma unroll
        for (int a = 0; a < RA; ++a) ya[a] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int a = 0; a < 4; ++a) ua[a] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int q = 0; q < RA; ++q) {
#pragma unroll 4
            for (int s = 16 * q; s < 16 * q + 16; ++s) {
                const float4 vv = *reinterpret_cast<const float4*>(vs + s * HS + 4 * tc);
#pragma unroll
                for (int a = q; a < RA; ++a) {
                    const int t = tr + 16 * a;
                    const float sv = (a > q || s < t) ? sc[t * (C + 1) + s] : 0.f;
                    ya[a].x = fmaf(sv, vv.x, ya[a].x);
                    ya[a].y = fmaf(sv, vv.y, ya[a].y);
                    ya[a].z = fmaf(sv, vv.z, ya[a].z);
                    ya[a].w = fmaf(sv, vv.w, ya[a].w);
                }
#pragma unroll
                for (int a = 0; a < 4; ++a) {
                    const float kr = K[s * LD + tr + 16 * a];
                    ua[a].x = fmaf(kr, vv.x, ua[a].x);
                    ua[a].y = fmaf(kr, vv.y, ua[a].y);
                    ua[a].z = fmaf(kr, vv.z, ua[a].z);
                    ua[a].w = fmaf(kr, vv.w, ua[a].w);
                }
            }
        }
#pragma unroll
        for (int a = 0; a < RA; ++a) {
            const int t = tr + 16 * a;
            const float4 vt = *reinterpret_cast<const float4*>(vs + t * HS + 4 * tc);
            ya[a] = decay_add(dg[t], vt, ya[a]);
        }
        float* yb = y + (((int64_t)b * S + t0 + tr) * H + h) * HS + 4 * tc;  // row tr; row tr + 16a at 16a * H * HS
#pragma unroll
        for (int a = 0; a < RA; ++a) *reinterpret_cast<float4*>(yb + (int64_t)16 * a * H * HS) = ya[a];
        float* Ub = U + (bh * nc + c) * HS * HS;
#pragma unroll
        for (int a = 0; a < 4; ++a) *reinterpret_cast<float4*>(Ub + (tr + 16 * a) * HS + 4 * tc) = ua[a];
    }
}

template <int C>
constexpr size_t inter_smem_bytes() {
    return (size_t)(HS * LDV + HS * (C + 4)) * sizeof(float);  // state [64][LDV], rdec [64][C+4]
}

constexpr int THREADS2 = 128;  // pass 2: all 448 blocks of the served shape resident at once

// One block per (chunk, head, batch), the longest carries first: the state
// entering chunk c, S_{c-1} (state0 for c = 0), then y += rdec @ S_{c-1};
// the last chunk's block also writes the last state. Thread (tr, tc) owns
// state rows tr + 8a and y rows 8tr .. 8tr + 7, columns 4tc .. 4tc + 3.
template <int C>
__global__ void __launch_bounds__(THREADS2, 4)
wkv6_inter_kernel(const float* __restrict__ s0, const float* __restrict__ U,
                  const float* __restrict__ ecl, const float* __restrict__ rdec,
                  float* __restrict__ y, float* __restrict__ s_out, int S, int H) {
    extern __shared__ float smem[];
    float* Ss = smem;            // [HS][LDV]
    float* rd = Ss + HS * LDV;   // [HS][C+4] rdec, channel-major

    const int tid = threadIdx.x;
    const int nc = gridDim.x;
    const int c = nc - 1 - blockIdx.x;
    const int h = blockIdx.y, b = blockIdx.z;
    const int t0 = c * C;
    const int64_t bh = (int64_t)b * H + h;
    const int tr = tid / 16, tc = tid % 16;

    float4 st[8];
    const float* s0b = s0 + bh * HS * HS;
#pragma unroll
    for (int a = 0; a < 8; ++a) st[a] = *reinterpret_cast<const float4*>(s0b + (tr + 8 * a) * HS + 4 * tc);

#pragma unroll
    for (int m = 0; m < C * HS / 4 / THREADS2; ++m) {
        const int idx = tid + m * THREADS2;
        const int i = idx / (C / 4), t = 4 * (idx % (C / 4));
        cp_async<16>(rd + i * (C + 4) + t, rdec + ((bh * nc + c) * HS + i) * C + t);
    }

    // the carry: S_m = 2^{cw_last,m} * S_{m-1} + U_m for m < c; the loads of
    // U_{m+1} are in flight while U_m is applied
    float4 un[8];
    float en[8];
    auto load = [&](int m) {
        const float* Um = U + (bh * nc + m) * HS * HS;
        const float* em = ecl + (bh * nc + m) * HS;
#pragma unroll
        for (int a = 0; a < 8; ++a) {
            un[a] = *reinterpret_cast<const float4*>(Um + (tr + 8 * a) * HS + 4 * tc);
            en[a] = em[tr + 8 * a];
        }
    };
    if (c > 0) load(0);
    for (int m = 0; m < c; ++m) {
        float4 uc[8];
        float ec[8];
#pragma unroll
        for (int a = 0; a < 8; ++a) {
            uc[a] = un[a];
            ec[a] = en[a];
        }
        if (m + 1 < c) load(m + 1);
#pragma unroll
        for (int a = 0; a < 8; ++a) st[a] = decay_add(ec[a], st[a], uc[a]);
    }
#pragma unroll
    for (int a = 0; a < 8; ++a) *reinterpret_cast<float4*>(Ss + (tr + 8 * a) * LDV + 4 * tc) = st[a];
    if (c == nc - 1) {
        load(c);
        float* so = s_out + bh * HS * HS;
#pragma unroll
        for (int a = 0; a < 8; ++a)
            *reinterpret_cast<float4*>(so + (tr + 8 * a) * HS + 4 * tc) = decay_add(en[a], st[a], un[a]);
    }
    cp_async_wait_all();
    __syncthreads();

    constexpr int RA = C / 8;  // y rows per thread: 8tr .. 8tr + RA - 1
    float4 acc[RA];
#pragma unroll
    for (int a = 0; a < RA; ++a) acc[a] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int i = 0; i < HS; ++i) {
        const float4 sv = *reinterpret_cast<const float4*>(Ss + i * LDV + 4 * tc);
#pragma unroll
        for (int q = 0; q < RA / 4; ++q) {
            const float4 rv = *reinterpret_cast<const float4*>(rd + i * (C + 4) + RA * tr + 4 * q);
            acc[4 * q] = decay_add(rv.x, sv, acc[4 * q]);
            acc[4 * q + 1] = decay_add(rv.y, sv, acc[4 * q + 1]);
            acc[4 * q + 2] = decay_add(rv.z, sv, acc[4 * q + 2]);
            acc[4 * q + 3] = decay_add(rv.w, sv, acc[4 * q + 3]);
        }
    }
#pragma unroll
    for (int a = 0; a < RA; ++a) {
        float4* yp = reinterpret_cast<float4*>(y + (((int64_t)b * S + t0 + RA * tr + a) * H + h) * HS + 4 * tc);
        const float4 yv = *yp;
        *yp = make_float4(yv.x + acc[a].x, yv.y + acc[a].y, yv.z + acc[a].z, yv.w + acc[a].w);
    }
}

template <int C>
int launch(const float* w, const float* r, const float* k, const float* v, const float* u,
           const float* s0, float* y, float* s_out, float* U, float* ecl, float* rdec,
           int B, int S, int H, const Strides& st, cudaStream_t stream) {
    const size_t smem1 = intra_smem_bytes<C>(), smem2 = inter_smem_bytes<C>();
    const int nc = S / C;
    cudaError_t err;
    static bool attributes_set = false;  // once per process: the call costs host time on every launch
    if (!attributes_set) {
        err = cudaFuncSetAttribute(wkv6_intra_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
        if (err != cudaSuccess) return (int)err;
        err = cudaFuncSetAttribute(wkv6_inter_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
        if (err != cudaSuccess) return (int)err;
        attributes_set = true;
    }
    const dim3 grid(nc, H, B);
    wkv6_intra_kernel<C><<<grid, THREADS, smem1, stream>>>(w, r, k, v, u, y, U, ecl, rdec, S, H, st);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    wkv6_inter_kernel<C><<<grid, THREADS2, smem2, stream>>>(s0, U, ecl, rdec, y, s_out, S, H);
    return (int)cudaGetLastError();
}

}  // namespace

// w/r/k/v (B, S, H, 64) fp32 through `strides` = 12 element strides, the
// (batch, seq, head) strides of w, r, k and v in that order, unit stride
// over the head dim; u (H, 64), state0 (B, H, 64, 64), y (B, S, H, 64) and
// s_out (B, H, 64, 64) contiguous fp32. Scratch, written and read by the
// two passes: U (B, H, S/chunk, 64, 64), ecl (B, H, S/chunk, 64) and rdec
// (B, H, S/chunk, 64, chunk), fp32, 16-byte aligned, as is state0. S must be a multiple of chunk, and
// chunk 32 or 64. Returns a cudaError_t (0 = both passes launched).
extern "C" int repro_wkv6_fwd(const void* w, const void* r, const void* k, const void* v,
                              const void* u, const void* state0, void* y, void* s_out,
                              void* U, void* ecl, void* rdec,
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
    const float *uf = (const float*)u, *s0f = (const float*)state0;
    float *yf = (float*)y, *sof = (float*)s_out, *Uf = (float*)U, *ef = (float*)ecl, *rdf = (float*)rdec;
    if (chunk == 64) return launch<64>(wf, rf, kf, vf, uf, s0f, yf, sof, Uf, ef, rdf, B, S, H, st, cs);
    if (chunk == 32) return launch<32>(wf, rf, kf, vf, uf, s0f, yf, sof, Uf, ef, rdf, B, S, H, st, cs);
    return (int)cudaErrorInvalidValue;
}
