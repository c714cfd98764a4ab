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
// materialised, unlike the TPU wrapper's concatenate), every byte is read
// once and written once, and each thread moves the widest access the
// alignment of both pointers, the segment length and the stride allow
// (16, 8, 4, 2 or 1 bytes), so aligned layouts run as 16-byte coalesced
// loads and stores. Unpack fuses the zero fill into the same pass.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int64_t MAX_BLOCKS = 8192;
// 32-bit indexing below this many elements: leaves room for the last
// grid-stride step (p + MAX_BLOCKS * THREADS) without overflow
constexpr int64_t INDEX32_LIMIT = ((int64_t)1 << 31) - MAX_BLOCKS * THREADS;

template <typename V, typename I>
__global__ void __launch_bounds__(THREADS)
pack_kernel(const V* __restrict__ src, V* __restrict__ out, I total, I vps, I stride_v) {
    for (I p = (I)blockIdx.x * THREADS + threadIdx.x; p < total; p += (I)gridDim.x * THREADS) {
        const I seg = p / vps;
        const I off = p - seg * vps;
        out[p] = src[seg * stride_v + off];
    }
}

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

template <typename V>
int pack_as(const void* src, void* out, int64_t nseg, int64_t seg_bytes, int64_t stride_bytes,
            cudaStream_t st) {
    const int64_t W = sizeof(V);
    const int64_t vps = seg_bytes / W, stride_v = stride_bytes / W, total = nseg * vps;
    if (total == 0) return 0;
    const unsigned grid = grid_for(total);
    if (nseg * (stride_v > vps ? stride_v : vps) < INDEX32_LIMIT)
        pack_kernel<V, int32_t><<<grid, THREADS, 0, st>>>((const V*)src, (V*)out, (int32_t)total,
                                                          (int32_t)vps, (int32_t)stride_v);
    else
        pack_kernel<V, int64_t><<<grid, THREADS, 0, st>>>((const V*)src, (V*)out, total, vps, stride_v);
    return (int)cudaGetLastError();
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
// buffer `out`. stride_bytes >= seg_bytes when nseg > 1. Returns a
// cudaError_t (0 = launched).
extern "C" int repro_dt_pack(const void* src, void* out, int64_t nseg, int64_t seg_bytes,
                             int64_t stride_bytes, void* stream) {
    if (nseg < 0 || seg_bytes < 0 || (nseg > 1 && stride_bytes < seg_bytes))
        return (int)cudaErrorInvalidValue;
    if (nseg <= 1) stride_bytes = seg_bytes;
    const int64_t q[4] = {(int64_t)(uintptr_t)src, (int64_t)(uintptr_t)out, seg_bytes, stride_bytes};
    cudaStream_t st = (cudaStream_t)stream;
    switch (vector_width(q, 4)) {
        case 16: return pack_as<uint4>(src, out, nseg, seg_bytes, stride_bytes, st);
        case 8: return pack_as<uint2>(src, out, nseg, seg_bytes, stride_bytes, st);
        case 4: return pack_as<uint32_t>(src, out, nseg, seg_bytes, stride_bytes, st);
        case 2: return pack_as<uint16_t>(src, out, nseg, seg_bytes, stride_bytes, st);
        default: return pack_as<uint8_t>(src, out, nseg, seg_bytes, stride_bytes, st);
    }
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
