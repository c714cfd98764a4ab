// Datatype pack / unpack for Hopper (sm_90a): the MPI datatype engine's
// uniform-stride fast path, on the card.
//
// Replaces the Pallas TPU kernels `pack_kernel` / `_pack_call` / `dt_pack`
// and `unpack_kernel` / `_unpack_call` / `dt_unpack` in
// src/repro/kernels/dt_pack.py, together with the window building of
// `pack_datatype` / `unpack_datatype` in src/repro/kernels/ops.py.
//
// What it computes: a layout proven uniform by `pack_info` is `nseg`
// segments of `seg_bytes`, segment i starting `stride_bytes * i` bytes after
// the first. Pack gathers them into a dense buffer; unpack writes a whole
// output buffer of `out_bytes`: segment bytes from the packed buffer, every
// other byte (gaps, head before the first segment, tail after the last)
// zero. Both move bytes only, so they are byte-exact for every dtype.
//
// What bounds it on this card: pure data movement, zero arithmetic — device
// memory bandwidth (3.35 TB/s on an H100 SXM). Pack must read and write
// nseg*seg_bytes; unpack must read nseg*seg_bytes and write out_bytes.
// What the design does about it: the kernels address the segments straight
// from the flat buffer's base (no padded (nseg, stride) window is ever
// materialised, unlike the TPU wrapper's concatenate) and every byte is read
// once and written once.
//
// Pack: the caller's plan (`pack_plan` in kernels/dt_pack.py, a pure function
// of the layout and the two pointers' alignment) fixes the access width (the
// widest of 16, 8, 4, 2 or 1 bytes that divides both pointers, the segment
// length and the stride) and a grid of equal spans of the packed output, one
// per block. Each thread issues its loads for 64 bytes (at most 16 vectors)
// before any store, so every SM keeps tens of KB of reads in flight from its
// first cycle, and finds each vector's segment by a multiply-shift divide
// instead of a hardware divide. Loads stream the source (evict-first), as it
// is read once. The entry picks 32- or 64-bit indices from the largest index
// the kernel forms. A bulk-copy (TMA) design, one thread per block moving 1-D
// `cp.async.bulk` chunks through a ring of shared memory
// (tools/pack_bulk.cu), was timed against this one on an H100 and was no
// faster at any layout timed (PERF.md §6).
//
// Unpack: one thread per output vector, the zero fill fused into the pass.
//
// Unpack into (`repro_dt_unpack_into`): the in-place scatter a paged KV
// cache needs to write positions [a, a+n) of a page whose other positions
// are live. It writes segment bytes only and leaves every other byte of the
// output as it was (the host engine's `datatype.unpack` contract, not the
// TPU kernel's fresh zeroed buffer). It is the pack with the roles swapped:
// the same plan (`pack_plan` with the strided side and the dense side
// exchanged), the grid over the packed bytes, the packed loads streamed and
// the stores addressed by the same multiply-shift divide. Bounded the same
// way: it reads and writes nseg*seg_bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int64_t MAX_BLOCKS = 8192;
// 32-bit indexing below this many elements: leaves room for the last
// grid-stride step (p + MAX_BLOCKS * THREADS) without overflow
constexpr int64_t INDEX32_LIMIT = ((int64_t)1 << 31) - MAX_BLOCKS * THREADS;

// -------------------------------------------------------------------- pack

template <typename T>
__device__ __forceinline__ T least(T a, T b) { return a < b ? a : b; }

// vectors in flight per thread: 64 bytes, at most 16 vectors
template <typename V>
__host__ __device__ constexpr int pack_ilp() { return 64 / (int)sizeof(V) < 16 ? 64 / (int)sizeof(V) : 16; }

__device__ __forceinline__ uint32_t mul_hi(uint32_t a, uint32_t b) { return __umulhi(a, b); }
__device__ __forceinline__ uint64_t mul_hi(uint64_t a, uint64_t b) { return __umul64hi(a, b); }

// Block b owns packed vectors [b*span, min(total, (b+1)*span)). Per step,
// thread t moves vectors base + t + i*THREADS, i < ILP: all ILP loads are
// issued before the first store. The segment of vector p is
// mul_hi(p, div_mul) >> div_shift (`fast_divider`); I is the index type
// `pack_as` chose. SCATTER = false is the pack (strided `src`, dense `out`);
// SCATTER = true the unpack into (dense `src`, strided `out`).
template <typename V, typename I, bool SCATTER>
__global__ void __launch_bounds__(THREADS, 4)
pack_kernel(const V* __restrict__ src, V* __restrict__ out, I total, I span, I vps, I stride_v,
            typename std::make_unsigned<I>::type div_mul, int div_shift) {
    using U = typename std::make_unsigned<I>::type;
    constexpr int ILP = pack_ilp<V>();
    const I b0 = (I)blockIdx.x * span;
    const I b1 = least(total, b0 + span);
    auto strided = [&](I p) -> I {
        const I seg = vps == 1 ? p : (I)(mul_hi((U)p, div_mul) >> div_shift);
        return seg * stride_v + (p - seg * vps);
    };
    for (I base = b0 + (I)threadIdx.x; base < b1; base += THREADS * ILP) {
        V r[ILP];
#pragma unroll
        for (int i = 0; i < ILP; ++i) {
            const I p = base + i * THREADS;
            if (p < b1) r[i] = __ldcs(src + (SCATTER ? p : strided(p)));
        }
#pragma unroll
        for (int i = 0; i < ILP; ++i) {
            const I p = base + i * THREADS;
            if (p < b1) out[SCATTER ? strided(p) : p] = r[i];
        }
    }
}

// ------------------------------------------------------------------ unpack

template <typename V, typename I>
__global__ void __launch_bounds__(THREADS)
unpack_kernel(const V* __restrict__ packed, V* __restrict__ out, I total, I nseg, I vps,
              I stride_v, I disp_v) {
    for (I p = (I)blockIdx.x * THREADS + threadIdx.x; p < total; p += (I)gridDim.x * THREADS) {
        V val{};
        if (p >= disp_v) {
            const I rel = p - disp_v;
            const I seg = rel / stride_v;
            const I off = rel - seg * stride_v;
            if (seg < nseg && off < vps) val = packed[seg * vps + off];
        }
        out[p] = val;
    }
}

int vector_width(const int64_t* quantities, int n) {
    int w = 16;
    for (int i = 0; i < n; ++i)
        while (w > 1 && quantities[i] % w != 0) w >>= 1;
    return w;
}

unsigned grid_for(int64_t total) {
    int64_t blocks = (total + THREADS - 1) / THREADS;
    if (blocks < 1) blocks = 1;
    return (unsigned)(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS);
}

// (mul, shift) with n / d == mul_hi(n, mul) >> shift for every
// 0 <= n < 2^(bits-1), bits the width of U (Granlund and Montgomery's
// round-up method: mul = ceil(2^(bits-1+l) / d), l = ceil(log2 d), which
// fits in U). The kernel does not divide by d == 1.
template <typename U>
void fast_divider(U d, U* mul, int* shift) {
    *mul = 0;
    *shift = 0;
    if (d <= 1) return;
    int l = 0;
    for (U x = d - 1; x; x >>= 1) ++l;
    const unsigned __int128 num = (unsigned __int128)1 << (8 * sizeof(U) - 1 + l);
    *mul = (U)((num + d - 1) / d);
    *shift = l - 1;
}

template <typename V, typename I, bool SCATTER>
int launch_pack(const void* src, void* out, int64_t grid, int64_t total, int64_t span, int64_t vps,
                int64_t stride_v, cudaStream_t st) {
    using U = typename std::make_unsigned<I>::type;
    U mul;
    int shift;
    fast_divider<U>((U)vps, &mul, &shift);
    pack_kernel<V, I, SCATTER><<<(unsigned)grid, THREADS, 0, st>>>((const V*)src, (V*)out, (I)total, (I)span,
                                                                  (I)vps, (I)stride_v, mul, shift);
    return (int)cudaGetLastError();
}

// 32-bit indices where every index the kernel forms stays below 2^31: a
// strided offset, or a step past the end of a block's span
template <typename V, bool SCATTER>
int pack_as(const void* src, void* out, int64_t nseg, int64_t seg_bytes, int64_t stride_bytes,
            int64_t grid, int64_t span_bytes, cudaStream_t st) {
    const int64_t W = sizeof(V);
    const int64_t vps = seg_bytes / W, stride_v = stride_bytes / W, total = nseg * vps, span = span_bytes / W;
    const int64_t strided_reach = nseg * (stride_v > vps ? stride_v : vps);
    const int64_t dense_reach = total + span + (int64_t)THREADS * pack_ilp<V>();
    if (strided_reach < ((int64_t)1 << 31) && dense_reach < ((int64_t)1 << 31))
        return launch_pack<V, int32_t, SCATTER>(src, out, grid, total, span, vps, stride_v, st);
    return launch_pack<V, int64_t, SCATTER>(src, out, grid, total, span, vps, stride_v, st);
}

// The checks both entries make of a plan, and its launch. `strided` is the
// side addressed by segments, `dense` the packed side.
template <bool SCATTER>
int plan_and_launch(const void* src, void* out, const void* strided, const void* dense, int64_t nseg,
                    int64_t seg_bytes, int64_t stride_bytes, int width, int64_t grid, int64_t span_bytes,
                    void* stream) {
    if (nseg < 0 || seg_bytes < 0 || (nseg > 1 && stride_bytes < seg_bytes))
        return (int)cudaErrorInvalidValue;
    if (nseg <= 1) stride_bytes = seg_bytes;
    const int64_t total = nseg * seg_bytes;
    if (total == 0) return 0;
    const int64_t q[4] = {(int64_t)(uintptr_t)strided, (int64_t)(uintptr_t)dense, seg_bytes, stride_bytes};
    if (width < 1 || width > 16 || (width & (width - 1)) || vector_width(q, 4) < width)
        return (int)cudaErrorInvalidValue;
    if (grid < 1 || grid > INT32_MAX || span_bytes < 1 || span_bytes % width || (grid - 1) * span_bytes >= total ||
        grid * span_bytes < total)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    switch (width) {
        case 16: return pack_as<uint4, SCATTER>(src, out, nseg, seg_bytes, stride_bytes, grid, span_bytes, st);
        case 8: return pack_as<uint2, SCATTER>(src, out, nseg, seg_bytes, stride_bytes, grid, span_bytes, st);
        case 4: return pack_as<uint32_t, SCATTER>(src, out, nseg, seg_bytes, stride_bytes, grid, span_bytes, st);
        case 2: return pack_as<uint16_t, SCATTER>(src, out, nseg, seg_bytes, stride_bytes, grid, span_bytes, st);
        default: return pack_as<uint8_t, SCATTER>(src, out, nseg, seg_bytes, stride_bytes, grid, span_bytes, st);
    }
}

template <typename V>
int unpack_as(const void* packed, void* out, int64_t nseg, int64_t seg_bytes, int64_t stride_bytes,
              int64_t disp_bytes, int64_t out_bytes, cudaStream_t st) {
    const int64_t W = sizeof(V);
    const int64_t vps = seg_bytes / W, stride_v = stride_bytes / W;
    const int64_t disp_v = disp_bytes / W, total = out_bytes / W;
    if (total == 0) return 0;
    const unsigned grid = grid_for(total);
    if (total < INDEX32_LIMIT && nseg * vps < INDEX32_LIMIT)
        unpack_kernel<V, int32_t><<<grid, THREADS, 0, st>>>(
            (const V*)packed, (V*)out, (int32_t)total, (int32_t)nseg, (int32_t)vps,
            (int32_t)stride_v, (int32_t)disp_v);
    else
        unpack_kernel<V, int64_t><<<grid, THREADS, 0, st>>>((const V*)packed, (V*)out, total, nseg,
                                                            vps, stride_v, disp_v);
    return (int)cudaGetLastError();
}

}  // namespace

// Gather `nseg` segments of `seg_bytes`, `stride_bytes` apart, starting at
// `src` (the buffer's base plus the layout's displacement) into the dense
// buffer `out`. stride_bytes >= seg_bytes when nseg > 1. The rest is the
// caller's plan (`pack_plan` in kernels/dt_pack.py): `width` the access width
// in bytes; `grid` blocks, block b owning packed bytes
// [b*span_bytes, (b+1)*span_bytes). A plan that does not fit the layout is
// refused, not repaired. Returns a cudaError_t (0 = launched).
extern "C" int repro_dt_pack(const void* src, void* out, int64_t nseg, int64_t seg_bytes,
                             int64_t stride_bytes, int width, int64_t grid, int64_t span_bytes, void* stream) {
    return plan_and_launch<false>(src, out, src, out, nseg, seg_bytes, stride_bytes, width, grid, span_bytes,
                                  stream);
}

// Scatter the dense `packed` buffer into `nseg` segments of `seg_bytes`,
// `stride_bytes` apart, starting `disp_bytes` into `out`; every other byte
// of `out` keeps its value. The plan is the pack's with the roles swapped
// (`pack_plan` over `out + disp_bytes` and `packed`). The caller checks that
// the last segment ends inside `out`. Returns a cudaError_t (0 = launched).
extern "C" int repro_dt_unpack_into(const void* packed, void* out, int64_t nseg, int64_t seg_bytes,
                                    int64_t stride_bytes, int64_t disp_bytes, int width, int64_t grid,
                                    int64_t span_bytes, void* stream) {
    if (disp_bytes < 0) return (int)cudaErrorInvalidValue;
    char* dst = (char*)out + disp_bytes;
    return plan_and_launch<true>(packed, dst, dst, packed, nseg, seg_bytes, stride_bytes, width, grid, span_bytes,
                                 stream);
}

// Write all `out_bytes` of `out`: the segments of `packed` at
// `disp_bytes + i * stride_bytes`, zero everywhere else. The caller checks
// that the last segment ends inside `out`. Returns a cudaError_t.
extern "C" int repro_dt_unpack(const void* packed, void* out, int64_t nseg, int64_t seg_bytes,
                               int64_t stride_bytes, int64_t disp_bytes, int64_t out_bytes,
                               void* stream) {
    if (nseg < 0 || seg_bytes < 0 || disp_bytes < 0 || (nseg > 1 && stride_bytes < seg_bytes))
        return (int)cudaErrorInvalidValue;
    if (nseg <= 1 || seg_bytes == 0) stride_bytes = seg_bytes > 0 ? seg_bytes : 1;
    const int64_t q[6] = {(int64_t)(uintptr_t)packed, (int64_t)(uintptr_t)out, seg_bytes,
                          stride_bytes, disp_bytes, out_bytes};
    cudaStream_t st = (cudaStream_t)stream;
    switch (vector_width(q, 6)) {
        case 16: return unpack_as<uint4>(packed, out, nseg, seg_bytes, stride_bytes, disp_bytes, out_bytes, st);
        case 8: return unpack_as<uint2>(packed, out, nseg, seg_bytes, stride_bytes, disp_bytes, out_bytes, st);
        case 4: return unpack_as<uint32_t>(packed, out, nseg, seg_bytes, stride_bytes, disp_bytes, out_bytes, st);
        case 2: return unpack_as<uint16_t>(packed, out, nseg, seg_bytes, stride_bytes, disp_bytes, out_bytes, st);
        default: return unpack_as<uint8_t>(packed, out, nseg, seg_bytes, stride_bytes, disp_bytes, out_bytes, st);
    }
}
