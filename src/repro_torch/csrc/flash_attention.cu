// Blocked causal (flash) attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention_kernel` /
// `flash_attention` in src/repro/kernels/flash_attention.py and the GQA
// head folding of `gqa_flash_attention` in src/repro/kernels/ops.py.
//
// What it computes (identical contract to the TPU kernel): for every
// (batch, query head) an online-softmax attention over K/V tiles with fp32
// running max `m`, running sum `l` and accumulator `acc`, scale 1/sqrt(hd),
// masked logits set to -1e30 on the diagonal tile, tiles strictly above the
// diagonal skipped in causal mode, and output acc / max(l, 1e-30) rounded to
// the input type.
//
// Layout: q (B, S, nq, hd) and k/v (B, S, nkv, hd), each addressed through
// its own (batch, seq, head) element strides with a unit hd stride, so the
// JAX package's layout is read in place. Query head h reads KV head
// h / (nq / nkv) by index: no repeated KV copy exists anywhere.
//
// What bounds it on this card: at the serving shapes (B = 1, S <= 512,
// 16 heads, hd 64) a call is 32-128 blocks of a few MFLOP each, so neither
// the 989 TFLOP/s of the bf16 tensor cores nor the 3.35 TB/s of HBM is
// reached: the time is the latency of one block's chain of K/V tiles (load,
// Q·Kᵀ, softmax, P·V) plus the launch. What the design does about it, for
// bf16 (the serving dtype):
//   - one warpgroup (128 threads) per 64-query tile of one (batch, head),
//     the longest causal rows first, 41 KB of shared memory at hd 64 so
//     several blocks share an SM;
//   - Q is loaded once and K/V tiles of 64 keys stream through a two-stage
//     ring with 16-byte `cp.async` copies, the next tile in flight while the
//     current one is multiplied (no TMA: every call has new base pointers,
//     and a descriptor per launch would cost host time on a host-bound path);
//   - tiles are stored with the 128-byte swizzle (an hd-64 bf16 row is
//     exactly 128 bytes; hd 128 is two such 64-column sub-tiles), and both
//     products run on the tensor cores as `wgmma.mma_async` m64n64k16 with
//     fp32 accumulators: S = Q·Kᵀ with A and B from shared memory (K is
//     K-major as stored), O += P·V with A = P from registers (the
//     accumulator layout of S is the A-register layout, so P never touches
//     shared memory) and B = V, MN-major, through the B-transpose bit;
//   - the online softmax runs on the accumulator fragment in registers: a
//     row lives in one quad, so its max needs two shuffles, and its sum is
//     kept per thread and reduced once at the end.
// fp32 inputs keep the CUDA-core kernel below (fp32 FMAs, register tiles of
// 4 rows x 4 keys, K/V in padded shared memory): TF32 tensor cores would not
// hold the fp32 tolerance.
//
// Head dims: 64, 96, 128 and 256 (the zoo's: qwen and granite 64, phi-3
// 96, llama3 and internlm2 128, gemma3's global layers 256). The fp32
// kernel takes each as it is (hd 256: 214,016 bytes of shared memory). The
// bf16 kernel stores a row as ceil(hd/64) swizzled 64-column sub-tiles; at
// hd 96 the second sub-tile is half used: Q.K^T runs only the hd/16 = 6 k16
// steps over real columns, and V's columns 96..127 are zeroed once per block
// (cp.async never writes them), so P.V's last 32 output columns hold zeros
// that are not written back. One padded layout keeps one wgmma shape (n64)
// and one swizzle for every hd, at the cost of a quarter of P.V's products
// at hd 96. At hd 256 one warpgroup holding all of O (128 fp32 registers
// a thread beside the 32 of S) hit 255 registers and spilled 276 bytes a
// thread; so at hd > 128 a block has two warpgroups over the same 64 query
// rows: both compute the same S = Q.K^T and softmax (the products are
// repeated, the loads are shared), and each owns half of O's sub-tiles.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per K/V tile
constexpr int THREADS = 256;  // fp32 kernel: 16 x 16 thread grid over the (BQ, BK) tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }

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

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), cp.async K/V ring, P in registers
// ---------------------------------------------------------------------------

constexpr int WG = 128;            // threads of one warpgroup

// warpgroups of a bf16 block: two at hd > 128, each owning half of O's columns
__host__ __device__ constexpr int bf16_warpgroups(int hd) { return hd > 128 ? 2 : 1; }
constexpr int SUB_BYTES = 64 * 128;  // one 64-row x 64-column bf16 sub-tile (8 atoms of 8 x 128 B)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `c` (8 bf16 columns) of row `r` in a tile of
// 64 rows stored as hd/64 sub-tiles of 64 columns, each with the 128-byte
// swizzle: chunk index XOR (row mod 8), the layout `wgmma` reads as
// LayoutType B128.
__device__ __forceinline__ uint32_t swz(int r, int c) {
    return (uint32_t)((c >> 3) * SUB_BYTES + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

// `wgmma` shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, each >> 4. Sub-tiles are 1024-byte aligned, so the
// base offset is 0.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
           ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }
// cp.async writes are generic-proxy writes; wgmma reads through the async proxy
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// keeps the compiler from touching accumulator registers across an
// asynchronous wgmma: every read or write of `d` is ordered after this point
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D(64x64, fp32) (+)= A(64x16, bf16, shared, K-major) * B(16x64, bf16, shared, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
}

// D(64x64, fp32) += A(64x16, bf16, registers) * B(16x64, bf16, shared, MN-major: transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
    return *reinterpret_cast<uint32_t*>(&v);
}

// 64 rows x HD columns of bf16, rows `row_stride` elements apart, into the
// swizzled tile at shared address `dst`: 16-byte cp.async copies,
// neighbouring threads on neighbouring chunks of a row.
template <int HD, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src, int64_t row_stride, int tid) {
    constexpr int CPR = HD / 8;  // 16-byte chunks per row
#pragma unroll
    for (int m = 0; m < 64 * CPR / NT; ++m) {
        const int idx = tid + NT * m;
        const int r = idx / CPR, c = idx % CPR;
        cp_async16(dst + swz(r, c), src + r * row_stride + c * 8);
    }
}

template <int HD>
__global__ void __launch_bounds__(WG * bf16_warpgroups(HD))
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                      int S, int nq, int group,
                      int64_t qsb, int64_t qss, int64_t qsh,
                      int64_t ksb, int64_t kss, int64_t ksh,
                      int64_t vsb, int64_t vss, int64_t vsh,
                      float scale_log2, int causal) {
    constexpr int NSUB = (HD + 63) / 64;      // 64-column sub-tiles per row (the last one padded at hd 96)
    constexpr int TILE = NSUB * SUB_BYTES;    // bytes of one 64-row tile
    constexpr int NT = WG * bf16_warpgroups(HD);  // threads of the block
    constexpr int NOWN = NSUB / bf16_warpgroups(HD);  // O sub-tiles one warpgroup owns
    extern __shared__ uint8_t smem_raw[];
    // swizzle atoms must sit on 1024-byte boundaries
    const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t Qs = base;
    const uint32_t Ks0 = base + TILE;         // K ring: stages at Ks0, Ks0 + TILE
    const uint32_t Vs0 = base + 3 * TILE;     // V ring: stages at Vs0, Vs0 + TILE

    const int tid = threadIdx.x;
    const int wg = tid / WG;  // this warpgroup owns O's sub-tiles wg*NOWN .. wg*NOWN + NOWN - 1
    const int warp = (tid % WG) / 32, lane = tid % 32;
    const int n_qt = gridDim.x;
    const int qt = n_qt - 1 - blockIdx.x;  // longest causal rows first
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int hk = h / group;
    const int q0 = qt * BQ;

    const __nv_bfloat16* qb = q + b * qsb + h * qsh + (int64_t)q0 * qss;
    const __nv_bfloat16* kb = k + b * ksb + hk * ksh;
    const __nv_bfloat16* vb = v + b * vsb + hk * vsh;

    const int n_kt = causal ? qt + 1 : S / BK;  // causal: tiles above the diagonal hold no visible key
    if constexpr (HD % 64 != 0) {  // V's padded columns: zeros, so P.V adds nothing there (made visible by the first fence)
        constexpr int PAD = NSUB * 8 - HD / 8;  // 16-byte chunks of padding per row
        uint8_t* vs_generic = smem_raw + (Vs0 - smem_u32(smem_raw));
        for (int i = tid; i < 2 * 64 * PAD; i += NT) {
            const int stage = i / (64 * PAD), r = (i / PAD) % 64, c = HD / 8 + i % PAD;
            *reinterpret_cast<uint4*>(vs_generic + stage * TILE + swz(r, c)) = make_uint4(0u, 0u, 0u, 0u);
        }
    }
    load_tile<HD, NT>(Qs, qb, qss, tid);
    load_tile<HD, NT>(Ks0, kb, kss, tid);
    load_tile<HD, NT>(Vs0, vb, vss, tid);
    cp_async_commit();

    // rows r0 = 16*warp + lane/4 and r0 + 8 of the tile; accumulator element
    // 4j+e sits at column 8j + 2*(lane%4) + (e&1), row r0 + 8*(e>>1)
    const int r0 = 16 * warp + lane / 4;
    const int cq = 2 * (lane % 4);
    float m_run[2] = {NEG_INF, NEG_INF};  // running max, in log2 units of the scaled logits
    float l_run[2] = {0.f, 0.f};          // this thread's share of the running sum
    float acc[NOWN][32];
#pragma unroll
    for (int n = 0; n < NOWN; ++n)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[n][i] = 0.f;

    for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt & 1;
        if (kt + 1 < n_kt) {  // the next tile loads while this one is multiplied
            load_tile<HD, NT>(Ks0 + (st ^ 1) * TILE, kb + (int64_t)(kt + 1) * BK * kss, kss, tid);
            load_tile<HD, NT>(Vs0 + (st ^ 1) * TILE, vb + (int64_t)(kt + 1) * BK * vss, vss, tid);
        }
        cp_async_commit();  // possibly empty: keeps "all but the newest group" meaning this tile
        cp_async_wait1();
        fence_proxy_async();
        __syncthreads();

        // S = Q K^T: HD/16 steps of k16; a k16 step is 32 bytes along a
        // 128-byte swizzled row, or the next sub-tile
        float s[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = 0.f;
        fence_regs(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
            const uint32_t off = (kk / 4) * SUB_BYTES + (kk % 4) * 32;
            wgmma_ss(s, desc_sw128(Qs + off, 16, 1024), desc_sw128(Ks0 + st * TILE + off, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(s);

        // online softmax on the fragment, in log2 units: x = s * scale * log2(e)
        const bool diag = causal && kt == qt;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            float mx = NEG_INF;
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    float x = s[4 * j + 2 * hr + e] * scale_log2;
                    if (diag && 8 * j + cq + e > r0 + 8 * hr) x = NEG_INF;
                    s[4 * j + 2 * hr + e] = x;
                    mx = fmaxf(mx, x);
                }
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_new = fmaxf(m_run[hr], mx);
            const float alpha = exp2f(m_run[hr] - m_new);
            float psum = 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const float p = exp2f(s[4 * j + 2 * hr + e] - m_new);
                    s[4 * j + 2 * hr + e] = p;
                    psum += p;
                }
            l_run[hr] = alpha * l_run[hr] + psum;
            m_run[hr] = m_new;
#pragma unroll
            for (int n = 0; n < NOWN; ++n)
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    acc[n][4 * j + 2 * hr] *= alpha;
                    acc[n][4 * j + 2 * hr + 1] *= alpha;
                }
        }

        // O += P V: P as bf16 A fragments straight from the S accumulator
        uint32_t pa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
            pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
            pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
            pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
        }
#pragma unroll
        for (int n = 0; n < NOWN; ++n) fence_regs(acc[n]);
        wgmma_fence();
#pragma unroll
        for (int n = 0; n < NOWN; ++n)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)  // 16 keys = two 8-row atoms: 2048 bytes
                wgmma_rs(acc[n], pa[kk],
                         desc_sw128(Vs0 + st * TILE + (wg * NOWN + n) * SUB_BYTES + kk * 2048, 1024, 1024));
        wgmma_commit();
        wgmma_wait0();
#pragma unroll
        for (int n = 0; n < NOWN; ++n) fence_regs(acc[n]);
        __syncthreads();  // every warp is done with this stage before it is refilled
    }

    float inv[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        float l = l_run[hr];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        inv[hr] = 1.f / fmaxf(l, 1e-30f);
    }
    __nv_bfloat16* ob = o + (((int64_t)b * S + q0) * nq + h) * HD;
#pragma unroll
    for (int n = 0; n < NOWN; ++n)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int col0 = 64 * (wg * NOWN + n) + 8 * j;
            if (col0 >= HD) continue;  // padded columns (hd 96) are not written
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
                const int row = r0 + 8 * hr, col = col0 + cq;
                *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)row * nq * HD + col) =
                    __floats2bfloat162_rn(acc[n][4 * j + 2 * hr] * inv[hr], acc[n][4 * j + 2 * hr + 1] * inv[hr]);
            }
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

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int S, int nq, int nkv,
                const int64_t* qst, const int64_t* kst, const int64_t* vst, int causal,
                cudaStream_t stream) {
    // cp.async moves 16 bytes: every base pointer and (batch, seq, head)
    // stride must be a multiple of 8 elements
    const uintptr_t ptrs = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o;
    int64_t strides = 0;
    for (int a = 0; a < 3; ++a) strides |= qst[a] | kst[a] | vst[a];
    if ((ptrs & 15) != 0 || (strides & 7) != 0) return (int)cudaErrorMisalignedAddress;
    const size_t smem = (size_t)5 * ((HD + 63) / 64) * SUB_BYTES + 1024;  // Q, 2 K and 2 V stages, alignment slack
    static bool attribute_set = false;  // once per process: the call costs host time on every launch
    if (!attribute_set) {
        cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<HD>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        attribute_set = true;
    }
    dim3 grid(S / BQ, nq, B);
    flash_fwd_bf16_kernel<HD><<<grid, WG * bf16_warpgroups(HD), smem, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, (__nv_bfloat16*)o,
        S, nq, nq / nkv, qst[0], qst[1], qst[2], kst[0], kst[1], kst[2], vst[0], vst[1], vst[2],
        1.4426950408889634f / sqrtf((float)HD), causal);
    return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (CUDA-core kernel), 1 = bfloat16 (tensor-core kernel;
// 16-byte aligned pointers, strides multiples of 8). Strides are (batch,
// seq, head) in elements; the hd stride is 1 and the output is contiguous
// (B, S, nq, hd). Returns a cudaError_t (0 = launched).
extern "C" int repro_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                         int B, int S, int nq, int nkv, int hd, int dtype,
                                         const int64_t* qst, const int64_t* kst,
                                         const int64_t* vst, int causal, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (S % BQ != 0 || nkv <= 0 || nq % nkv != 0) return (int)cudaErrorInvalidValue;
#define REPRO_FLASH_HD(HDV)                                                                           \
    if (hd == HDV)                                                                                    \
        return dtype == 0 ? launch<float, HDV>(q, k, v, o, B, S, nq, nkv, qst, kst, vst, causal, st)  \
                          : launch_bf16<HDV>(q, k, v, o, B, S, nq, nkv, qst, kst, vst, causal, st);
    if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
    REPRO_FLASH_HD(64)
    REPRO_FLASH_HD(96)
    REPRO_FLASH_HD(128)
    REPRO_FLASH_HD(256)
#undef REPRO_FLASH_HD
    return (int)cudaErrorInvalidValue;
}
