// Decode attention (K4) for Hopper (sm_90a): one new query token a slot
// against the slot's K/V cache, read in place up to the slot's length.
//
// Replaces no TPU kernel. The JAX package's decode attention is an einsum
// under a mask (`repro.models.common.attend` with `decode_mask`), which XLA
// fuses into its own loop over the cache. The port ran the same einsums
// eagerly: each permuted the whole (B, T, nkv, hd) cache into a contiguous
// (b, n, h, t) operand, so every layer of every step read and wrote the
// whole cache twice over, and the logits were masked, softmaxed and cast
// over all T positions. This kernel takes that place on the card.
//
// What it computes: for slot b and query head h (KV head h / G), over the
// slot's first n_b = min(pos_b + 1, T) cache rows (a full cache's rows
// 0..pos, and every row of a ring cache once pos + 1 >= T): logits q.K[t]
// scaled by 1/sqrt(hd), a softmax and P.V, all three in fp32, the output
// rounded once to q's dtype. pos is read on the device: the host never
// waits for it.
//
// Layout: q (B, nq, hd) through its (batch, head) strides; K and V
// (B, T, nkv, hd) through their own (batch, seq, head) strides, the hd
// stride 1, so the serving cache is read where it lies, with no copy.
//
// What bounds it on this card: bytes. Each K/V element read is used for
// 2 G FLOPs (G = nq / nkv query heads a KV head), about 0.5 FLOP a byte at
// G = 1 in bf16, far below the ~295 the tensor cores need; so the products
// run on the CUDA cores and the design is about reading the rows in use,
// once, at the memory's rate:
//   - grid (B * nkv, splits): a block takes one (slot, KV head) and one
//     chunk of positions (flash-decoding); a block whose chunk starts at or
//     past n_b exits at once, so rows past a slot's length are never read.
//     The wrapper sizes `splits` from (B, nkv, T) and the SM count, never
//     from pos: enough blocks to fill every SM several times over, and
//     chunks short enough that slots of different lengths balance;
//   - the block holds all G query heads of its KV head, so each K/V row
//     leaves device memory once a group;
//   - K/V tiles of TP rows stream through a three-stage ring of 16-byte
//     `cp.async.cg` copies (L2 only: each byte is used once), two tiles in
//     flight while one is computed; at hd 96 in bf16 a block holds 81 KB
//     and two share an SM, about 100 KB in flight an SM;
//   - rows are padded by 16 bytes in shared memory, so the logits pass, a
//     thread to a (head, row) reading whole rows as 16-byte vectors, has no
//     bank conflict; the softmax is a warp to a head; P.V a thread to a
//     (head, column pair), the warp reading contiguous row bytes;
//   - the scale and log2(e) are folded into q once, so the online softmax
//     runs on exp2; its running max, sum and accumulator stay in fp32 in
//     shared memory;
//   - with more than one split, each chunk's (max, sum, accumulator) goes
//     to an fp32 workspace and `decode_attention_combine_kernel` merges the
//     chunks a slot has (it reads pos too); with one split the block
//     normalises and writes the output itself.
//
// Head dims: 64, 96, 128 and 256 (the zoo's) and 16 (the smoke presets',
// which the examples serve on the card). dtypes: bf16 (serving) and fp32
// (the zoo's fp32 checks). G up to MAX_G.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 3;
constexpr int MAX_G = 16;

template <typename T, int HD>
struct Tile {
    static constexpr int ROW = HD * (int)sizeof(T);                // bytes of one cache row
    static constexpr int CPR = ROW / 16;                           // 16-byte chunks a row
    static constexpr int EPV = 16 / (int)sizeof(T);                // elements a chunk
    static constexpr int ROWP = ROW + 16;                          // padded row in shared memory
    static constexpr int TP = ROW <= 256 ? 64 : (ROW <= 512 ? 32 : 16);  // rows a tile
    static constexpr int RING = STAGES * 2 * TP * ROWP;            // K and V stages
    static_assert(ROW % 16 == 0, "a row is whole 16-byte chunks");
};

__host__ __device__ constexpr int state_floats(int G, int HD, int TP) {
    // q, acc (G x HD each), logits (G x TP), running max, sum and rescale (G each)
    return G * (2 * HD + TP + 3);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// two neighbouring elements of a shared-memory row, widened to fp32
__device__ __forceinline__ float2 pair(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 pair(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// acc + (one 16-byte chunk of a K row) . (the matching q elements, fp32)
__device__ __forceinline__ float dot16(uint4 w, const float* q, float acc, float) {
    const float4 a = *reinterpret_cast<const float4*>(q);
    acc = fmaf(__uint_as_float(w.x), a.x, acc);
    acc = fmaf(__uint_as_float(w.y), a.y, acc);
    acc = fmaf(__uint_as_float(w.z), a.z, acc);
    return fmaf(__uint_as_float(w.w), a.w, acc);
}
__device__ __forceinline__ float dot16(uint4 w, const float* q, float acc, __nv_bfloat16) {
    // a 32-bit word holds elements 2i (low half) and 2i + 1 (high half)
    const float4 a = *reinterpret_cast<const float4*>(q);
    const float4 b = *reinterpret_cast<const float4*>(q + 4);
    acc = fmaf(__uint_as_float(w.x << 16), a.x, acc);
    acc = fmaf(__uint_as_float(w.x & 0xffff0000u), a.y, acc);
    acc = fmaf(__uint_as_float(w.y << 16), a.z, acc);
    acc = fmaf(__uint_as_float(w.y & 0xffff0000u), a.w, acc);
    acc = fmaf(__uint_as_float(w.z << 16), b.x, acc);
    acc = fmaf(__uint_as_float(w.z & 0xffff0000u), b.y, acc);
    acc = fmaf(__uint_as_float(w.w << 16), b.z, acc);
    return fmaf(__uint_as_float(w.w & 0xffff0000u), b.w, acc);
}

__device__ __forceinline__ int slot_length(const void* pos, int pos64, int b, int T) {
    const int64_t p = pos64 ? static_cast<const int64_t*>(pos)[b] : (int64_t) static_cast<const int32_t*>(pos)[b];
    return (int)(p + 1 < (int64_t)T ? p + 1 : (int64_t)T);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const void* __restrict__ pos, int pos64, T* __restrict__ out,
                        float* __restrict__ part_acc, float* __restrict__ part_ml,
                        int T_len, int nkv, int G, int chunk, int splits,
                        int64_t qsb, int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
                        int64_t vsb, int64_t vss, int64_t vsh, float q_scale) {
    using C = Tile<T, HD>;
    constexpr int TP = C::TP, ROWP = C::ROWP, CPR = C::CPR, EPV = C::EPV;
    extern __shared__ __align__(16) unsigned char smem[];

    const int b = blockIdx.x / nkv, hk = blockIdx.x % nkv;
    const int n = slot_length(pos, pos64, b, T_len);
    const int s0 = blockIdx.y * chunk;
    if (s0 >= n) return;  // this chunk lies past the slot's length
    const int s1 = min(s0 + chunk, n);
    const int ntiles = (s1 - s0 + TP - 1) / TP;

    float* q_s = reinterpret_cast<float*>(smem + C::RING);  // [G][HD], pre-scaled
    float* acc_s = q_s + G * HD;                            // [G][HD]
    float* p_s = acc_s + G * HD;                            // [G][TP] logits, then probabilities
    float* m_s = p_s + G * TP;                              // running max (log2 domain)
    float* l_s = m_s + G;                                   // running sum
    float* a_s = l_s + G;                                   // this tile's rescale of acc

    const int tid = threadIdx.x;
    const int nq = nkv * G;
    const T* kb = k + b * ksb + hk * ksh;
    const T* vb = v + b * vsb + hk * vsh;
    const uint32_t ring = (uint32_t)__cvta_generic_to_shared(smem);

    // issue the 16-byte copies of tile `tile`'s valid rows into stage `stage`
    auto load = [&](int tile, int stage) {
        const int t0 = s0 + tile * TP;
        const int rows = min(TP, s1 - t0);
        const uint32_t ks = ring + stage * 2 * TP * ROWP;
        const uint32_t vs = ks + TP * ROWP;
        for (int i = tid; i < rows * CPR; i += THREADS) {
            const int r = i / CPR, c = i % CPR;
            cp_async16(ks + r * ROWP + c * 16, kb + (int64_t)(t0 + r) * kss + c * EPV);
            cp_async16(vs + r * ROWP + c * 16, vb + (int64_t)(t0 + r) * vss + c * EPV);
        }
    };

#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
        if (i < ntiles) load(i, i);
        cp_async_commit();
    }

    for (int i = tid; i < G * HD; i += THREADS) {
        const int g = i / HD, d = i % HD;
        q_s[i] = to_f32(q[b * qsb + (int64_t)(hk * G + g) * qsh + d]) * q_scale;
        acc_s[i] = 0.f;
    }
    for (int g = tid; g < G; g += THREADS) {
        m_s[g] = -INFINITY;
        l_s[g] = 0.f;
    }

    const int warp = tid / 32, lane = tid % 32;
    for (int it = 0; it < ntiles; ++it) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();  // tile `it` landed for every thread; the last tile's readers are done
        if (it + STAGES - 1 < ntiles) load(it + STAGES - 1, (it + STAGES - 1) % STAGES);
        cp_async_commit();  // possibly empty: keeps the group count one a tile

        const int nv = min(TP, s1 - (s0 + it * TP));  // valid rows of this tile
        const unsigned char* Ks = smem + (it % STAGES) * 2 * TP * ROWP;
        const unsigned char* Vs = Ks + TP * ROWP;

        // logits: a thread a (head, row), whole rows as 16-byte vectors
        for (int i = tid; i < G * TP; i += THREADS) {
            const int g = i / TP, t = i % TP;
            if (t < nv) {
                const uint4* kr = reinterpret_cast<const uint4*>(Ks + t * ROWP);
                const float* qg = q_s + g * HD;
                float a0 = 0.f, a1 = 0.f;
#pragma unroll
                for (int c = 0; c < CPR; c += 2) {
                    a0 = dot16(kr[c], qg + c * EPV, a0, T());
                    if (c + 1 < CPR) a1 = dot16(kr[c + 1], qg + (c + 1) * EPV, a1, T());
                }
                p_s[i] = a0 + a1;
            }
        }
        __syncthreads();

        // online softmax: a warp a head (TP <= 64: two rows a lane)
        for (int g = warp; g < G; g += WARPS) {
            float* pg = p_s + g * TP;
            const float x0 = lane < nv ? pg[lane] : -INFINITY;
            const float x1 = lane + 32 < nv ? pg[lane + 32] : -INFINITY;
            float mx = fmaxf(x0, x1);
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
            const float m_old = m_s[g];
            const float m_new = fmaxf(m_old, mx);  // finite: the tile has a valid row
            const float e0 = lane < nv ? exp2f(x0 - m_new) : 0.f;
            const float e1 = lane + 32 < nv ? exp2f(x1 - m_new) : 0.f;
            if (lane < nv) pg[lane] = e0;
            if (lane + 32 < nv) pg[lane + 32] = e1;
            float sum = e0 + e1;
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
            if (lane == 0) {
                const float alpha = exp2f(m_old - m_new);  // 0 on the first tile
                m_s[g] = m_new;
                l_s[g] = l_s[g] * alpha + sum;
                a_s[g] = alpha;
            }
        }
        __syncthreads();

        // P.V: a thread a (head, column pair), two rows at a time
        for (int i = tid; i < G * (HD / 2); i += THREADS) {
            const int g = i / (HD / 2), c = i % (HD / 2);
            const float* pg = p_s + g * TP;
            float2 u = make_float2(0.f, 0.f), w = make_float2(0.f, 0.f);
            int t = 0;
            for (; t + 1 < nv; t += 2) {
                const float2 v0 = pair(reinterpret_cast<const T*>(Vs + t * ROWP) + 2 * c);
                const float2 v1 = pair(reinterpret_cast<const T*>(Vs + (t + 1) * ROWP) + 2 * c);
                const float p0 = pg[t], p1 = pg[t + 1];
                u.x = fmaf(p0, v0.x, u.x);
                u.y = fmaf(p0, v0.y, u.y);
                w.x = fmaf(p1, v1.x, w.x);
                w.y = fmaf(p1, v1.y, w.y);
            }
            if (t < nv) {
                const float2 v0 = pair(reinterpret_cast<const T*>(Vs + t * ROWP) + 2 * c);
                u.x = fmaf(pg[t], v0.x, u.x);
                u.y = fmaf(pg[t], v0.y, u.y);
            }
            float* ac = acc_s + g * HD + 2 * c;
            const float alpha = a_s[g];
            ac[0] = fmaf(ac[0], alpha, u.x + w.x);
            ac[1] = fmaf(ac[1], alpha, u.y + w.y);
        }
    }
    __syncthreads();

    const int64_t row0 = (int64_t)b * nq + hk * G;  // (slot, first query head of the group)
    if (splits == 1) {
        for (int i = tid; i < G * HD; i += THREADS) {
            const int g = i / HD;
            store(out + (row0 + g) * HD + i % HD, acc_s[i] / l_s[g]);
        }
    } else {
        for (int i = tid; i < G * HD; i += THREADS) {
            const int g = i / HD;
            part_acc[((row0 + g) * splits + blockIdx.y) * HD + i % HD] = acc_s[i];
        }
        for (int g = tid; g < G; g += THREADS) {
            float* ml = part_ml + ((row0 + g) * splits + blockIdx.y) * 2;
            ml[0] = m_s[g];
            ml[1] = l_s[g];
        }
    }
}

// Merge the chunks of one (slot, query head): a thread an output column.
template <typename T>
__global__ void decode_attention_combine_kernel(const float* __restrict__ part_acc,
                                                const float* __restrict__ part_ml,
                                                const void* __restrict__ pos, int pos64, T* __restrict__ out,
                                                int T_len, int nq, int hd, int chunk, int splits) {
    const int row = blockIdx.x;  // b * nq + h
    const int n = slot_length(pos, pos64, row / nq, T_len);
    const int ns = (n + chunk - 1) / chunk;  // the chunks whose blocks ran
    const float* ml = part_ml + (int64_t)row * splits * 2;
    const float* acc = part_acc + (int64_t)row * splits * hd;
    float M = -INFINITY;
    for (int s = 0; s < ns; ++s) M = fmaxf(M, ml[2 * s]);
    float L = 0.f;
    for (int s = 0; s < ns; ++s) L = fmaf(ml[2 * s + 1], exp2f(ml[2 * s] - M), L);
    for (int d = threadIdx.x; d < hd; d += blockDim.x) {
        float o = 0.f;
        for (int s = 0; s < ns; ++s) o = fmaf(acc[s * hd + d], exp2f(ml[2 * s] - M), o);
        store(out + (int64_t)row * hd + d, o / L);
    }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* pos, int pos64, void* out,
           float* part_acc, float* part_ml, int B, int T_len, int nq, int nkv,
           const int64_t* qst, const int64_t* kst, const int64_t* vst, int chunk, int splits,
           cudaStream_t stream) {
    using C = Tile<T, HD>;
    const int G = nq / nkv;
    // cp.async moves 16 bytes: K/V bases and (batch, seq, head) strides in whole 16-byte units
    int64_t strides = 0;
    for (int a = 0; a < 3; ++a) strides |= (kst[a] | vst[a]) * (int64_t)sizeof(T);
    if ((((uintptr_t)k | (uintptr_t)v) & 15) != 0 || (strides & 15) != 0) return (int)cudaErrorMisalignedAddress;
    if (G < 1 || G > MAX_G || chunk % C::TP != 0 || splits < 1) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)C::RING + sizeof(float) * state_floats(G, HD, C::TP);
    static bool attribute_set = false;  // once per process: the call costs host time on every launch
    if (!attribute_set) {
        const size_t most = (size_t)C::RING + sizeof(float) * state_floats(MAX_G, HD, C::TP);
        cudaError_t err = cudaFuncSetAttribute(decode_attention_kernel<T, HD>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
        if (err != cudaSuccess) return (int)err;
        attribute_set = true;
    }
    const float q_scale = 1.4426950408889634f / sqrtf((float)HD);  // 1/sqrt(hd) and log2(e)
    dim3 grid(B * nkv, splits);
    decode_attention_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, pos, pos64, (T*)out, part_acc, part_ml,
        T_len, nkv, G, chunk, splits, qst[0], qst[1], kst[0], kst[1], kst[2], vst[0], vst[1], vst[2], q_scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return (int)err;
    decode_attention_combine_kernel<T><<<B * nq, HD, 0, stream>>>(part_acc, part_ml, pos, pos64, (T*)out,
                                                                 T_len, nq, HD, chunk, splits);
    return (int)cudaGetLastError();
}

}  // namespace

// q (B, nq, hd) with (batch, head) element strides `qst`; k/v (B, T, nkv, hd)
// with (batch, seq, head) element strides; the hd stride is 1 everywhere.
// pos (B,) int32 (pos64 = 0) or int64 (pos64 = 1) on the device. out
// (B, nq, hd) contiguous in q's dtype. dtype: 0 = float32, 1 = bfloat16
// (q, k, v and out alike). Blocks take `chunk` positions each (a multiple
// of 64), `splits` = ceil(T / chunk) of them a (slot, KV head); with
// splits > 1, part_acc (B, nq, splits, hd) and part_ml (B, nq, splits, 2)
// are fp32 workspace. Returns a cudaError_t (0 = launched).
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v, const void* pos, int pos64,
                                      void* out, void* part_acc, void* part_ml, int B, int T, int nq, int nkv,
                                      int hd, int dtype, const int64_t* qst, const int64_t* kst,
                                      const int64_t* vst, int chunk, int splits, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (nkv <= 0 || nq % nkv != 0 || T <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
    if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
    float* pa = (float*)part_acc;
    float* pm = (float*)part_ml;
#define REPRO_DECODE_HD(HDV)                                                                                    \
    if (hd == HDV)                                                                                              \
        return dtype == 0 ? launch<float, HDV>(q, k, v, pos, pos64, out, pa, pm, B, T, nq, nkv, qst, kst, vst, \
                                               chunk, splits, st)                                               \
                          : launch<__nv_bfloat16, HDV>(q, k, v, pos, pos64, out, pa, pm, B, T, nq, nkv, qst,   \
                                                       kst, vst, chunk, splits, st);
    REPRO_DECODE_HD(16)
    REPRO_DECODE_HD(64)
    REPRO_DECODE_HD(96)
    REPRO_DECODE_HD(128)
    REPRO_DECODE_HD(256)
#undef REPRO_DECODE_HD
    return (int)cudaErrorInvalidValue;
}
