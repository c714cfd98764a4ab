// Blocked causal (flash) attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention_kernel` /
// `flash_attention` in src/repro/kernels/flash_attention.py and the GQA
// head folding of `gqa_flash_attention` in src/repro/kernels/ops.py.
//
// What it computes (identical contract to the TPU kernel): for every
// (batch, query head) an online-softmax attention over K/V tiles with fp32
// running max `m`, running sum `l` and accumulator `acc`, scale 1/sqrt(hd),
// masked logits set to -1e30, tiles strictly above the diagonal skipped in
// causal mode, and output acc / max(l, 1e-30) rounded to the input type.
//
// Layout: q (B, S, nq, hd) and k/v (B, S, nkv, hd), each addressed through
// its own (batch, seq, head) element strides with a unit hd stride, so the
// JAX package's layout is read in place. Query head h reads KV head
// h / (nq / nkv) by index: no repeated KV copy exists anywhere.
//
// What bounds it on this card: at the serving shapes (S <= 512, hd 64) the
// work is ~4*S^2*hd/2 flops per head against 4*S*hd*2 bytes per head, i.e.
// compute-bound on paper. This first version runs the products as fp32
// FMAs on the CUDA cores (67 TFLOP/s peak, not the 989 TFLOP/s bf16 tensor
// cores), so its ceiling is the fp32 pipe and shared-memory bandwidth.
// What the design does about it: each 256-thread block owns one 64-query
// tile of one head and register-tiles 4 rows x 4 keys (scores) and
// 4 rows x hd/16 dims (output) per thread, so every shared-memory load
// feeds 2-4 FMAs; K/V tiles are staged once per block in shared memory
// (padded rows, conflict-free); the heavy diagonal-most query tiles are
// scheduled first. wgmma/TMA pipelining is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per K/V tile
constexpr int THREADS = 256;  // 16 x 16 thread grid over the (BQ, BK) tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int S, int nq, int group,
                 int64_t qsb, int64_t qss, int64_t qsh,
                 int64_t ksb, int64_t kss, int64_t ksh,
                 int64_t vsb, int64_t vss, int64_t vsh,
                 float scale, int causal) {
    constexpr int LD = HD + 1;      // padded row: column reads are conflict-free
    constexpr int DPT = HD / 16;    // output dims per thread
    extern __shared__ float smem[];
    float* Qs = smem;               // [BQ][LD]
    float* Ks = Qs + BQ * LD;       // [BK][LD]
    float* Vs = Ks + BK * LD;       // [BK][LD]
    float* Ps = Vs + BK * LD;       // [BQ][BK + 1]

    const int tid = threadIdx.x;
    const int ty = tid / 16;        // rows ty*4 .. ty*4+3
    const int tx = tid % 16;        // keys tx + 16*c, dims tx + 16*c
    const int n_qt = gridDim.x;
    const int qt = n_qt - 1 - blockIdx.x;  // longest causal rows first
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int hk = h / group;
    const int q0 = qt * BQ;

    const T* qb = q + b * qsb + h * qsh;
    const T* kb = k + b * ksb + hk * ksh;
    const T* vb = v + b * vsb + hk * vsh;

    for (int i = tid; i < BQ * HD; i += THREADS) {
        int r = i / HD, d = i % HD;
        Qs[r * LD + d] = to_f32(qb[(int64_t)(q0 + r) * qss + d]);
    }

    float m[4], l[4], acc[4][DPT];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = NEG_INF;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
    }

    // causal: tiles strictly above the diagonal hold no visible key
    const int n_kt = causal ? (q0 + BQ - 1) / BK + 1 : S / BK;
    for (int kt = 0; kt < n_kt; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();  // previous tile's readers are done (and Qs is loaded)
        for (int i = tid; i < BK * HD; i += THREADS) {
            int r = i / HD, d = i % HD;
            Ks[r * LD + d] = to_f32(kb[(int64_t)(k0 + r) * kss + d]);
            Vs[r * LD + d] = to_f32(vb[(int64_t)(k0 + r) * vss + d]);
        }
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) {
            float qv[4], kv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * LD + d];
#pragma unroll
            for (int c = 0; c < 4; ++c) kv[c] = Ks[(tx + 16 * c) * LD + d];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
        }

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int row = ty * 4 + i;
            const int qpos = q0 + row;
            float mx = NEG_INF;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                float x = s[i][c] * scale;
                if (causal && k0 + tx + 16 * c > qpos) x = NEG_INF;
                s[i][c] = x;
                mx = fmaxf(mx, x);
            }
            // the 16 lanes sharing `ty` are one aligned half-warp
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m[i], mx);
            const float alpha = expf(m[i] - m_new);
            float psum = 0.f;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                float p = expf(s[i][c] - m_new);
                Ps[row * (BK + 1) + tx + 16 * c] = p;
                psum += p;
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                psum += __shfl_xor_sync(0xffffffffu, psum, off);
            l[i] = alpha * l[i] + psum;
            m[i] = m_new;
#pragma unroll
            for (int c = 0; c < DPT; ++c) acc[i][c] *= alpha;
        }
        __syncthreads();

#pragma unroll 4
        for (int j = 0; j < BK; ++j) {
            float pv[4], vv[DPT];
#pragma unroll
            for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * (BK + 1) + j];
#pragma unroll
            for (int c = 0; c < DPT; ++c) vv[c] = Vs[j * LD + tx + 16 * c];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int c = 0; c < DPT; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
        }
    }

    T* ob = o + ((int64_t)b * S * nq + h) * HD;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty * 4 + i;
        const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
        for (int c = 0; c < DPT; ++c)
            from_f32(ob + (int64_t)row * nq * HD + tx + 16 * c, acc[i][c] * inv);
    }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int nq, int nkv,
           const int64_t* qst, const int64_t* kst, const int64_t* vst, int causal,
           cudaStream_t stream) {
    const size_t smem = (size_t)(3 * 64 * (HD + 1) + BQ * (BK + 1)) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(S / BQ, nq, B);
    flash_fwd_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)o, S, nq, nq / nkv,
        qst[0], qst[1], qst[2], kst[0], kst[1], kst[2], vst[0], vst[1], vst[2],
        1.0f / sqrtf((float)HD), causal);
    return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are (batch, seq, head) in
// elements; the hd stride is 1 and the output is contiguous (B, S, nq, hd).
// Returns a cudaError_t (0 = launched).
extern "C" int repro_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                         int B, int S, int nq, int nkv, int hd, int dtype,
                                         const int64_t* qst, const int64_t* kst,
                                         const int64_t* vst, int causal, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (S % BQ != 0 || nkv <= 0 || nq % nkv != 0) return (int)cudaErrorInvalidValue;
    if (dtype == 0 && hd == 64) return launch<float, 64>(q, k, v, o, B, S, nq, nkv, qst, kst, vst, causal, st);
    if (dtype == 0 && hd == 128) return launch<float, 128>(q, k, v, o, B, S, nq, nkv, qst, kst, vst, causal, st);
    if (dtype == 1 && hd == 64) return launch<__nv_bfloat16, 64>(q, k, v, o, B, S, nq, nkv, qst, kst, vst, causal, st);
    if (dtype == 1 && hd == 128) return launch<__nv_bfloat16, 128>(q, k, v, o, B, S, nq, nkv, qst, kst, vst, causal, st);
    return (int)cudaErrorInvalidValue;
}
