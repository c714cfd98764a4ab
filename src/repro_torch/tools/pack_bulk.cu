// The datatype pack as 1-D bulk copies for Hopper (sm_90a): the design the
// port's pack kernel (csrc/dt_pack.cu) was chosen over. Built and timed
// against it by tools/pack_bulk_ab.py; no path of the port calls it.
//
// Each segment is cut into chunks of at most `chunk` bytes, taken in packed
// order; block b owns chunks [b*per, (b+1)*per). One thread per block moves
// each chunk in with `cp.async.bulk` (global -> shared, completing on its
// stage's mbarrier) into a ring of `stages` buffers, and out with
// `cp.async.bulk` (shared -> global, one bulk group per chunk). A stage is
// refilled once the store that read it has finished reading
// (`wait_group.read`), so the load of chunk k + stages - 1 overlaps the store
// of chunk k. Source reads carry an L2 evict-first policy. Every address and
// size is a multiple of 16 bytes, which the entry checks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_STAGES = 8;
constexpr long long HANG_CYCLES = 2000000000LL;  // ~1 s: a wait this long is a fault, not a copy

__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
    const long long t0 = clock64();
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
        if (!done && clock64() - t0 > HANG_CYCLES) __trap();
    }
}

__global__ void __launch_bounds__(32)
pack_bulk_kernel(const char* __restrict__ src, char* __restrict__ out, int64_t seg_bytes, int64_t stride_bytes,
                 int64_t chunk, int64_t chunks_per_seg, int64_t nchunks, int64_t per_block, int stages) {
    extern __shared__ __align__(128) char ring[];
    __shared__ __align__(8) uint64_t bars[MAX_STAGES];
    if (threadIdx.x != 0) return;
    const int64_t c0 = (int64_t)blockIdx.x * per_block;
    const int64_t c1 = c0 + per_block < nchunks ? c0 + per_block : nchunks;
    if (c0 >= c1) return;
    const uint32_t ring0 = (uint32_t)__cvta_generic_to_shared(ring);
    const uint32_t bar0 = (uint32_t)__cvta_generic_to_shared(bars);
    for (int s = 0; s < stages; ++s)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar0 + 8 * s) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    uint64_t policy;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));

    auto piece = [&](int64_t c, int64_t* seg, int64_t* off) -> uint32_t {
        *seg = c / chunks_per_seg;
        *off = (c - *seg * chunks_per_seg) * chunk;
        return (uint32_t)(chunk < seg_bytes - *off ? chunk : seg_bytes - *off);
    };
    auto load = [&](int64_t c) {
        int64_t seg, off;
        const uint32_t len = piece(c, &seg, &off);
        const int s = (int)((c - c0) % stages);
        const uint32_t bar = bar0 + 8 * s;
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(len) : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
            " [%0], [%1], %2, [%3], %4;" ::"r"(ring0 + s * (uint32_t)chunk),
            "l"(src + seg * stride_bytes + off), "r"(len), "r"(bar), "l"(policy)
            : "memory");
    };

    for (int64_t c = c0; c < c1 && c < c0 + stages; ++c) load(c);
    for (int64_t c = c0; c < c1; ++c) {
        const int64_t j = c - c0;
        const int s = (int)(j % stages);
        wait_parity(bar0 + 8 * s, (uint32_t)((j / stages) & 1));
        int64_t seg, off;
        const uint32_t len = piece(c, &seg, &off);
        asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(out + seg * seg_bytes + off),
                     "r"(ring0 + s * (uint32_t)chunk), "r"(len)
                     : "memory");
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        // the previous chunk's stage takes the chunk `stages` after it once its store has read it
        if (j >= 1 && c - 1 + stages < c1) {
            asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
            load(c - 1 + stages);
        }
    }
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

}  // namespace

// Gather `nseg` segments of `seg_bytes`, `stride_bytes` apart, from `src`
// into the dense `out` in chunks of at most `chunk` bytes through `stages`
// shared-memory buffers per block, over at most `grid` blocks. Returns a
// cudaError_t (0 = launched); cudaErrorInvalidValue for a layout that is not
// 16-byte aligned throughout.
extern "C" int pack_bulk(const void* src, void* out, int64_t nseg, int64_t seg_bytes, int64_t stride_bytes,
                         int64_t chunk, int stages, int64_t grid, void* stream) {
    if (nseg <= 1) stride_bytes = seg_bytes;
    if (nseg < 1 || seg_bytes < 16 || stride_bytes < seg_bytes || chunk < 16 || chunk % 16 || stages < 2 ||
        stages > MAX_STAGES || grid < 1 || ((uintptr_t)src | (uintptr_t)out) % 16 || seg_bytes % 16 ||
        stride_bytes % 16)
        return (int)cudaErrorInvalidValue;
    const int64_t cps = (seg_bytes + chunk - 1) / chunk, nchunks = nseg * cps;
    const int64_t per = (nchunks + grid - 1) / grid;
    const int64_t blocks = (nchunks + per - 1) / per;
    const int smem = (int)(stages * chunk);
    cudaError_t e = cudaFuncSetAttribute(pack_bulk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    pack_bulk_kernel<<<(unsigned)blocks, 32, smem, (cudaStream_t)stream>>>(
        (const char*)src, (char*)out, seg_bytes, stride_bytes, chunk, cps, nchunks, per, stages);
    return (int)cudaGetLastError();
}
