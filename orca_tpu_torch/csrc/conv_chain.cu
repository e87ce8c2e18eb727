// Fused k=9 conv chains of the bp-resolution encoder tower, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of orca_tpu/ops/pallas/conv1d.py:
//   * fused_first_stage_packed (encoder stage 0): the one-hot 4->64 conv, then
//     three 64->64 convs, residual from the first chain conv, pool-4 epilogue;
//   * fused_conv_chain_packed (encoder stages 1-6): four k=9 convs, residual
//     from the second conv (none at the last stage), the next stage's
//     max-pool (4, 5, 5, 5, 2) in the epilogue.
// Both are the same chain of four k=9 "same" convs, so one design serves
// both; the first stage reads a uint8 quarter-scale (or float) one-hot input
// and does not mask it, the chain stages mask their input.
//
// Semantics per conv: fp32 accumulation plus bias, ReLU if the conv has one,
// zero every position outside the row's [vs, ve) (and outside [0, L)), round
// to the I/O dtype (bf16 or fp32). Output = last conv + residual conv, then
// max-pool by `pool` (floor length).
//
// Blocking (both dtypes): one block per (row, tile of T output positions); T
// is a multiple of 8 and of the pool, so pool windows never straddle tiles.
// The tile plus a 16-position halo per side (4 convs x 4) is loaded into
// shared memory, zero outside [0, L); each conv runs over a range 4 narrower
// per side, ping-ponging between two shared buffers kept in the I/O dtype;
// the residual conv's output stays in its buffer and the last conv adds into
// it in place; the max-pool epilogue reads that buffer and stores the pooled
// tile. The wrapper picks T per launch (ops/kernels/conv_chain.py plan_tile):
// the largest tile that still launches a full wave of blocks.
//
// Bound: at the encoder's shapes (64-128 channels, 4.2 Mb rows) each conv
// does 2*9*Cin*Cout operations per position against a few bytes of traffic
// per position, so the chain is bound by operations: in bf16 by the tensor
// cores (989 TFLOP/s dense on an H100 SXM), in fp32 by the CUDA cores.
//
// bf16 (fused_chain_mma_kernel): every conv runs on the tensor cores as nine
// shifted GEMMs, out[M, Cout] += in[M rows from t, Cin] . W_t[Cin, Cout], with
// wgmma.mma_async m64nCk16 (bf16 in, fp32 accumulate), both operands read
// from shared memory by descriptor, no swizzle:
//   * the activations are stored as K-major core-matrix columns (8 channels
//     x all rows, 16 bytes a row), so the A operand of tap t is the same
//     buffer at row m0 + t: any shift is a valid descriptor start;
//   * the weights stream once per block, tap by tap, through a two-slot
//     shared-memory ring filled by cp.async (tap t + 1, and at the end of a
//     conv the next conv's first tap, lands while tap t's wgmmas run; no
//     weight read goes through L1/L2 in the MMA loop). The copy scatters the
//     (9, Cin, Cout) row-major weights, as stored, into N-major core
//     matrices, so the wrapper repacks nothing;
//   * the two warpgroups hold the whole level's output tile as fp32
//     accumulators in registers (which bounds the tile: 512 rows at 64
//     channels, 256 at 96-128), and round it to bf16 where they write it
//     back to shared memory for the next conv;
//   * stage 0's 4-channel first conv is an im2col: its 9 taps x 4 channels
//     form one K = 36 row, zero-padded to 48, run as three k16 steps.
// What bounds it (measured with scripts/bench_conv_chain.py; PERF.md): the
// operands' shared-memory reads (4-6 KB per m64nCk16 at C = 64-128 take 75%
// to 100% of the shared-memory rate at the tensor-core peak), and the work
// outside the MMAs (the accumulator epilogues, the weight copies, the input
// loads), which one block per SM does not overlap with them.
//
// fp32: every multiply-add on the CUDA cores in fp32 (67 TFLOP/s on an H100
// SXM); fp32 on the tensor cores would need TF32 (about three digits, below
// the fp32 reference bar) or a 3xTF32 split. Two templates, chosen by the
// output width C:
//   * C = 64 and 96, encoder stages 0-1 and nearly all the fp32 FLOPs
//     (ffma_chain_kernel): each conv is one pass of the 256 threads over the
//     whole level, a micro-tile of PT positions x C / 8 channels a thread
//     (PT = 8 at 64 channels, 6 at 96: 64-72 accumulators), which bounds the
//     tile at 32 PT - 24 positions. The weights stream through a two-slot
//     shared-memory ring by cp.async, 4 input channels x 9 taps a slot, one
//     barrier a slot; the 8 channel lanes of a quarter-warp read 128
//     contiguous weight bytes and share one activation address, so no
//     shared-memory access conflicts;
//   * every other width, 128 at stages 2-6 (fused_chain_kernel, the
//     general template): work items of 8 positions x 4 channels handed out
//     round-robin, weights read through L1/L2, a tile of at most 160.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHalo = 16;  // 4 convs x 4 positions per side
constexpr int kTaps = 9;
constexpr int kPT = 8;  // positions per thread micro-tile
constexpr int kCT = 4;  // channels per thread micro-tile

template <typename IoT>
struct ChainWeights {
  const IoT* w[4];  // (9, Cin_k, C) each
  const IoT* b[4];  // (C,) each
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const uint8_t* p) {
  const uchar4 u = *reinterpret_cast<const uchar4*>(p);
  return make_float4(u.x, u.y, u.z, u.w);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float round_io(float v, float*) { return v; }

__device__ __forceinline__ float4 max4(float4 a, float4 b) {
  return make_float4(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z),
                     fmaxf(a.w, b.w));
}

// Level 0 of a block: input positions [s - 16, s + tile + 16) of row r, zero
// outside [0, L) (and outside [lo, hi) when the input is masked), times
// in_scale, into buf.
template <typename InT, typename IoT>
__device__ __forceinline__ void load_tile(const InT* __restrict__ x, IoT* buf,
                                          int r, int s, int L, int cin,
                                          int tile, int lo, int hi,
                                          int mask_input, float in_scale) {
  const int n0 = tile + 2 * kHalo;
  const int cin4 = cin / 4;
  const InT* xrow = x + (size_t)r * L * cin;
  for (int e = threadIdx.x; e < n0 * cin4; e += blockDim.x) {
    const int i = e / cin4;
    const int ch = (e % cin4) * 4;
    const int gp = s - kHalo + i;
    bool ok = gp >= 0 && gp < L;
    if (mask_input) ok = ok && gp >= lo && gp < hi;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ok) {
      v = load4(xrow + (size_t)gp * cin + ch);
      v.x *= in_scale;
      v.y *= in_scale;
      v.z *= in_scale;
      v.w *= in_scale;
    }
    store4(buf + i * cin + ch, v);
  }
}

// The block's output: max-pool the tile (`out`, positions from s) by `pool`
// and store the pooled positions below (L / pool) * pool of row r.
template <typename IoT>
__device__ __forceinline__ void pool_tile(const IoT* out, IoT* __restrict__ y,
                                          int r, int s, int L, int c,
                                          int tile, int pool) {
  const int lout = L / pool;
  const int q0 = s / pool;
  const int nq = tile / pool;
  const int c4 = c / 4;
  IoT* yrow = y + (size_t)r * lout * c;
  for (int e = threadIdx.x; e < nq * c4; e += blockDim.x) {
    const int q = e / c4;
    const int ch = (e % c4) * 4;
    if (q0 + q >= lout) continue;
    float4 m = load4(out + (q * pool) * c + ch);
    for (int k = 1; k < pool; ++k) m = max4(m, load4(out + (q * pool + k) * c + ch));
    store4(yrow + (size_t)(q0 + q) * c + ch, m);
  }
}

// ---------------------------------------------------------------------------
// fp32 at widths other than 64 and 96: the general CUDA-core template
// ---------------------------------------------------------------------------

// One k=9 conv over a shared-memory range: out[i] <- conv(in[i .. i+8]),
// i in [0, n_out); out[i] sits at global position pos0 + i. `in` has
// n_out + 8 positions of `cin` channels, `out` n_out positions of `cout`.
// With add_residual, out already holds the residual conv's output at the
// same positions; the rounded conv result is added to it in place.
template <typename IoT>
__device__ void conv_level(const IoT* __restrict__ in, int cin,
                           IoT* __restrict__ out, int cout, int n_out,
                           const IoT* __restrict__ w,
                           const IoT* __restrict__ b, bool relu,
                           bool add_residual, int pos0, int lo, int hi) {
  const int nct = cout / kCT;
  const int items = nct * (n_out / kPT);
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int co = (item % nct) * kCT;
    const int p0 = (item / nct) * kPT;
    float acc[kPT][kCT];
    const float4 bias = load4(b + co);
#pragma unroll
    for (int j = 0; j < kPT; ++j) {
      acc[j][0] = bias.x;
      acc[j][1] = bias.y;
      acc[j][2] = bias.z;
      acc[j][3] = bias.w;
    }
    for (int ci = 0; ci < cin; ci += 4) {
      float4 xin[kPT + kTaps - 1];
#pragma unroll
      for (int j = 0; j < kPT + kTaps - 1; ++j) {
        xin[j] = load4(in + (p0 + j) * cin + ci);
      }
#pragma unroll
      for (int t = 0; t < kTaps; ++t) {
        const IoT* wt = w + ((size_t)t * cin + ci) * cout + co;
        const float4 w0 = load4(wt);
        const float4 w1 = load4(wt + cout);
        const float4 w2 = load4(wt + 2 * cout);
        const float4 w3 = load4(wt + 3 * cout);
#pragma unroll
        for (int j = 0; j < kPT; ++j) {
          const float4 xv = xin[j + t];
          acc[j][0] = fmaf(xv.x, w0.x, acc[j][0]);
          acc[j][1] = fmaf(xv.x, w0.y, acc[j][1]);
          acc[j][2] = fmaf(xv.x, w0.z, acc[j][2]);
          acc[j][3] = fmaf(xv.x, w0.w, acc[j][3]);
          acc[j][0] = fmaf(xv.y, w1.x, acc[j][0]);
          acc[j][1] = fmaf(xv.y, w1.y, acc[j][1]);
          acc[j][2] = fmaf(xv.y, w1.z, acc[j][2]);
          acc[j][3] = fmaf(xv.y, w1.w, acc[j][3]);
          acc[j][0] = fmaf(xv.z, w2.x, acc[j][0]);
          acc[j][1] = fmaf(xv.z, w2.y, acc[j][1]);
          acc[j][2] = fmaf(xv.z, w2.z, acc[j][2]);
          acc[j][3] = fmaf(xv.z, w2.w, acc[j][3]);
          acc[j][0] = fmaf(xv.w, w3.x, acc[j][0]);
          acc[j][1] = fmaf(xv.w, w3.y, acc[j][1]);
          acc[j][2] = fmaf(xv.w, w3.z, acc[j][2]);
          acc[j][3] = fmaf(xv.w, w3.w, acc[j][3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kPT; ++j) {
      const int gpos = pos0 + p0 + j;
      const bool valid = gpos >= lo && gpos < hi;
      float4 v = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
      if (relu) {
        v.x = fmaxf(v.x, 0.f);
        v.y = fmaxf(v.y, 0.f);
        v.z = fmaxf(v.z, 0.f);
        v.w = fmaxf(v.w, 0.f);
      }
      if (!valid) v = make_float4(0.f, 0.f, 0.f, 0.f);
      IoT* dst = out + (p0 + j) * cout + co;
      if (add_residual) {
        const float4 r = load4(dst);
        v.x = round_io(v.x, dst) + r.x;
        v.y = round_io(v.y, dst) + r.y;
        v.z = round_io(v.z, dst) + r.z;
        v.w = round_io(v.w, dst) + r.w;
      }
      store4(dst, v);
    }
  }
}

// grid (ceil(L / tile), R); block kThreads; dynamic shared memory from
// chain_smem_bytes; IoT float. relu_mask bit k: conv k has a ReLU. residual: add the
// output of conv 1 (the second conv) to the output of conv 3.
template <typename InT, typename IoT>
__global__ void __launch_bounds__(kThreads)
    fused_chain_kernel(const InT* __restrict__ x, ChainWeights<IoT> wts,
                       const int* __restrict__ vs, const int* __restrict__ ve,
                       IoT* __restrict__ y, int L, int cin, int c, int tile,
                       int pool, int relu_mask, int residual, int mask_input,
                       float in_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cmax = cin > c ? cin : c;
  const size_t a_elems = ((size_t)(tile + 2 * kHalo) * cmax + 7) / 8 * 8;
  IoT* buf_a = reinterpret_cast<IoT*>(smem_raw);
  IoT* buf_b = buf_a + a_elems;

  const int r = blockIdx.y;
  const int s = blockIdx.x * tile;
  const int lo = max(vs[r], 0);
  const int hi = min(ve[r], L);

  load_tile(x, buf_a, r, s, L, cin, tile, lo, hi, mask_input, in_scale);
  __syncthreads();

  // conv 0: A (cin) -> B, positions [s - 12, s + tile + 12)
  conv_level(buf_a, cin, buf_b, c, tile + 24, wts.w[0], wts.b[0],
             relu_mask & 1, false, s - 12, lo, hi);
  __syncthreads();
  // conv 1: B -> A, positions [s - 8, s + tile + 8); kept as the residual
  conv_level(buf_b, c, buf_a, c, tile + 16, wts.w[1], wts.b[1],
             (relu_mask >> 1) & 1, false, s - 8, lo, hi);
  __syncthreads();
  // conv 2: A -> B, positions [s - 4, s + tile + 4)
  conv_level(buf_a, c, buf_b, c, tile + 8, wts.w[2], wts.b[2],
             (relu_mask >> 2) & 1, false, s - 4, lo, hi);
  __syncthreads();
  // conv 3: B -> A at offset 8 (position s), plus the residual in place
  IoT* out = buf_a + 8 * c;
  conv_level(buf_b, c, out, c, tile, wts.w[3], wts.b[3],
             (relu_mask >> 3) & 1, residual != 0, s, lo, hi);
  __syncthreads();

  pool_tile(out, y, r, s, L, c, tile, pool);
}

size_t chain_smem_bytes(int cin, int c, int tile, size_t elem) {
  const int cmax = cin > c ? cin : c;
  const size_t a_elems = ((size_t)(tile + 2 * kHalo) * cmax + 7) / 8 * 8;
  const size_t b_elems = (size_t)(tile + 2 * kHalo - 8) * c;
  return (a_elems + b_elems) * elem;
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core template
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kIm2colK = 48;    // stage 0's 9 taps x 4 channels, padded to 3 k16 steps
constexpr int kIm2colReal = 36;
constexpr int kWarpGroups = kThreads / 128;

// Per output width C: each of the two warpgroups holds MT m64 tiles of rows
// (tiles wg, wg + 2, ...) x all C channels of fp32 accumulators, C / 2 per
// thread and tile.
template <int C>
struct MmaPlan {
  static constexpr int MT = C == 64 ? 4 : 2;
  static constexpr int kMaxRows = 64 * kWarpGroups * MT;  // rows a level can cover
};

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Activations in shared memory are K-major core-matrix columns: channel
// group g (8 channels, 16 bytes) of row i at g * rows * 16 + i * 16. A conv
// tap's A operand, rows m0 + t .. m0 + t + 63, is then a plain descriptor at
// row m0 + t: any shift t is a valid start. `rows` is odd, so the 8 channel
// groups of one row fall on 8 distinct bank groups.
//
// Two activation buffers of `rows` = tile + 33 rows (the tile plus the
// 16-row halo per side, made odd), then a two-slot ring of one tap's
// weights, k0 or C rows of C channels. The rows an m64 tile computes past a
// level's end are discarded; their A reads may run past a channel group
// into the next one, or past the buffer into the next region (fewer than
// 64 rows of 16 bytes, less than the ring).
struct MmaLayout {
  int rows, act_bytes, slot_bytes, k0;
  __host__ __device__ MmaLayout(int cin, int c, int tile, bool first) {
    const int cmax = cin > c ? cin : c;
    rows = tile + 2 * kHalo + 1;
    act_bytes = rows * cmax * 2;
    k0 = first ? kIm2colK : cin;
    slot_bytes = (k0 > c ? k0 : c) * c * 2;
  }
  __host__ __device__ size_t bytes() const {
    return 2 * (size_t)act_bytes + 2 * (size_t)slot_bytes;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Order this thread's generic-proxy writes to shared memory (stores,
// cp.async) before the async proxy's (wgmma's) reads of them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads across a wgmma wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor, no swizzle: start address, leading byte
// offset (between core matrices along K) and stride byte offset (between
// core matrices along M or N), all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                             uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// D[64, N] (+)= A[64, 16] . B[16, N], both from shared memory: A K-major,
// B N-major (transposed); fp32 accumulators in the m64nN fragment order.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n96k16(float (&d)[48], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <int C>
__device__ __forceinline__ void wgmma_k16(float (&d)[C / 2], uint64_t desc_a,
                                          uint64_t desc_b, int scale_d) {
  if constexpr (C == 64) {
    wgmma_m64n64k16(d, desc_a, desc_b, scale_d);
  } else if constexpr (C == 96) {
    wgmma_m64n96k16(d, desc_a, desc_b, scale_d);
  } else {
    wgmma_m64n128k16(d, desc_a, desc_b, scale_d);
  }
}

// The chain's weights as one stream of (conv, tap) stages: conv 0 has
// `taps0` stages of k0 rows (9 taps of Cin, or stage 0's single im2col
// stage of 48 rows, 36 of them real), convs 1-3 nine stages of C rows each.
// Stage q goes to ring slot q & 1, in wgmma's no-swizzle N-major layout:
// 8 channels x 8 k rows make a 128-byte core matrix, k rows at 16 bytes,
// groups of 8 channels at kd * 16 bytes.
template <int C>
struct WeightStream {
  const bf16* w[4];
  uint32_t ring;
  int taps0, k0, k0_real, slot_bytes;

  __device__ void issue(int q) const {
    int k = 0, t = q;
    if (q >= taps0) {
      k = 1 + (q - taps0) / kTaps;
      t = (q - taps0) % kTaps;
    }
    const int kd = k == 0 ? k0 : C;
    const int kreal = k == 0 ? k0_real : C;
    const bf16* src = w[k] + (size_t)t * kreal * C;
    const uint32_t dst = ring + (q & 1) * slot_bytes;
    constexpr int cv = C / 8;
    for (int e = threadIdx.x; e < kd * cv; e += kThreads) {
      const int row = e / cv;
      const int col = (e % cv) * 8;
      const bool ok = row < kreal;
      cp_async16(dst + (col / 8) * kd * 16 + row * 16,
                 ok ? src + row * C + col : src, ok ? 16 : 0);
    }
    cp_async_commit();
  }
};

// One tap of one conv, for this warpgroup's m64 tiles: acc[mt] (+)=
// A[m0 + shift .., KD] . B[KD, C], issued back to back as one group. a_base
// is the input's row `shift`, group_bytes its channel-group stride; B is
// the ring slot at `slot`.
template <int C, int KD>
__device__ __forceinline__ void wgmma_tap(
    float (&acc)[MmaPlan<C>::MT][C / 2], uint32_t a_base, uint32_t group_bytes,
    uint32_t slot, int n_out, int wg, bool first_tap) {
  using P = MmaPlan<C>;
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < KD / 16; ++j) {
    const uint64_t desc_b = smem_desc(slot + j * 256, 128, KD * 16);
#pragma unroll
    for (int mt = 0; mt < P::MT; ++mt) {
      const int m0 = (wg + kWarpGroups * mt) * 64;
      if (m0 < n_out) {
        const uint64_t desc_a =
            smem_desc(a_base + m0 * 16 + 2 * j * group_bytes, group_bytes, 128);
        wgmma_k16<C>(acc[mt], desc_a, desc_b, (first_tap && j == 0) ? 0 : 1);
      }
    }
  }
  wgmma_commit();
}

// wgmma_tap for a K of 48 (stage 0's im2col), 64, 96 or 128.
template <int C>
__device__ __forceinline__ void wgmma_tap_k(
    float (&acc)[MmaPlan<C>::MT][C / 2], uint32_t a_base, uint32_t group_bytes,
    int kdim, uint32_t slot, int n_out, int wg, bool first_tap) {
  switch (kdim) {
    case kIm2colK:
      wgmma_tap<C, kIm2colK>(acc, a_base, group_bytes, slot, n_out, wg,
                             first_tap);
      break;
    case 64:
      wgmma_tap<C, 64>(acc, a_base, group_bytes, slot, n_out, wg, first_tap);
      break;
    case 96:
      wgmma_tap<C, 96>(acc, a_base, group_bytes, slot, n_out, wg, first_tap);
      break;
    default:
      wgmma_tap<C, 128>(acc, a_base, group_bytes, slot, n_out, wg, first_tap);
  }
}

// Write a conv's accumulators back to shared memory: + bias, ReLU, zero
// outside [lo, hi), round to bf16; with add_residual, add the (bf16) value
// already at the destination and round again. Thread (warp wq of the
// warpgroup, lane) holds rows 16 wq + lane / 4 (+ 8) of each m64 tile, and
// per 8 channels j the pair 8 j + 2 (lane % 4) in acc[4 j .. 4 j + 3]; the
// 8 rows x 16 bytes a warp stores per group are contiguous.
template <int C>
__device__ __forceinline__ void mma_epilogue(
    float (&acc)[MmaPlan<C>::MT][C / 2], unsigned char* out, int group_bytes,
    int n_out, int pos0, int lo, int hi, const bf16* __restrict__ bias,
    bool relu, bool add_residual, int wg, int wq, int lane) {
  using P = MmaPlan<C>;
  const int g = lane >> 2;
  const int tig = lane & 3;
  float2 bv[C / 8];
#pragma unroll
  for (int nj = 0; nj < C / 8; ++nj) {
    bv[nj] = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(bias + nj * 8 + 2 * tig));
  }
#pragma unroll
  for (int mt = 0; mt < P::MT; ++mt) {
    const int m0 = (wg + kWarpGroups * mt) * 64;
    if (m0 >= n_out) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + 16 * wq + g + 8 * h;
      if (row >= n_out) continue;
      const bool valid = pos0 + row >= lo && pos0 + row < hi;
      unsigned char* dst = out + row * 16 + 4 * tig;
#pragma unroll
      for (int nj = 0; nj < C / 8; ++nj) {
        float v0 = acc[mt][4 * nj + 2 * h] + bv[nj].x;
        float v1 = acc[mt][4 * nj + 2 * h + 1] + bv[nj].y;
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        if (!valid) v0 = v1 = 0.f;
        __nv_bfloat162* d2 =
            reinterpret_cast<__nv_bfloat162*>(dst + nj * group_bytes);
        if (add_residual) {
          const float2 r = __bfloat1622float2(*d2);
          v0 = __bfloat162float(__float2bfloat16_rn(v0)) + r.x;
          v1 = __bfloat162float(__float2bfloat16_rn(v1)) + r.y;
        }
        *d2 = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

__device__ __forceinline__ uint2 onehot_bf16x4(const uint8_t* p) {
  const uchar4 u = *reinterpret_cast<const uchar4*>(p);
  // {0, 1, 4} x 0.25 is exact in bf16
  const __nv_bfloat162 lo2 = __floats2bfloat162_rn(u.x * 0.25f, u.y * 0.25f);
  const __nv_bfloat162 hi2 = __floats2bfloat162_rn(u.z * 0.25f, u.w * 0.25f);
  return make_uint2(*reinterpret_cast<const uint32_t*>(&lo2),
                    *reinterpret_cast<const uint32_t*>(&hi2));
}

__device__ __forceinline__ uint2 onehot_bf16x4(const bf16* p) {
  return *reinterpret_cast<const uint2*>(p);
}

// grid (ceil(L / tile), R); block kThreads; dynamic shared memory
// MmaLayout(cin, C, tile, kFirst).bytes(). kFirst: stage 0 (cin 4, one-hot
// input of type InT, not masked, conv 0 as an im2col); else a chain stage
// (InT bf16, cin a multiple of 16, input masked).
template <typename InT, int C, bool kFirst>
__global__ void __launch_bounds__(kThreads, 1)
    fused_chain_mma_kernel(const InT* __restrict__ x, ChainWeights<bf16> wts,
                           const int* __restrict__ vs,
                           const int* __restrict__ ve, bf16* __restrict__ y,
                           int L, int cin, int tile, int pool, int relu_mask,
                           int residual) {
  using P = MmaPlan<C>;
  extern __shared__ __align__(128) unsigned char smem[];
  const MmaLayout lay(cin, C, tile, kFirst);
  unsigned char* buf_a = smem;
  unsigned char* buf_b = smem + lay.act_bytes;
  const uint32_t ring = smem_u32(buf_b + lay.act_bytes);
  const int group_bytes = lay.rows * 16;  // channel-group stride

  const int r = blockIdx.y;
  const int s = blockIdx.x * tile;
  const int lo = max(vs[r], 0);
  const int hi = min(ve[r], L);
  const int taps0 = kFirst ? 1 : kTaps;
  const int nstages = taps0 + 3 * kTaps;

  const WeightStream<C> ws{{wts.w[0], wts.w[1], wts.w[2], wts.w[3]},
                           ring,
                           taps0,
                           lay.k0,
                           kFirst ? kIm2colReal : cin,
                           lay.slot_bytes};
  ws.issue(0);  // conv 0's first weights land while the input loads

  if constexpr (kFirst) {
    // im2col row i (conv 0's output position s - 12 + i): the 9 positions
    // s - 16 + i + t, 4 channels each (half a channel group), then 12 zero
    // columns
    const int n_im = (tile + 24 + 15) / 16 * 16;
    const InT* xrow = x + (size_t)r * L * 4;
    for (int e = threadIdx.x; e < n_im * (kIm2colK / 4); e += kThreads) {
      const int i = e / (kIm2colK / 4);
      const int t = e % (kIm2colK / 4);
      const int gp = s - kHalo + i + t;
      uint2 v = make_uint2(0u, 0u);
      if (t < kTaps && gp >= 0 && gp < L) v = onehot_bf16x4(xrow + (size_t)gp * 4);
      *reinterpret_cast<uint2*>(buf_a + (t / 2) * group_bytes + i * 16 +
                                (t % 2) * 8) = v;
    }
  } else {
    // positions [s - 16, s + tile + 16), zero outside [0, L) ∩ [lo, hi)
    const int n0 = tile + 2 * kHalo;
    const int cv = cin / 8;
    const InT* xrow = x + (size_t)r * L * cin;
    for (int e = threadIdx.x; e < n0 * cv; e += kThreads) {
      const int i = e / cv;
      const int ch = (e % cv) * 8;
      const int gp = s - kHalo + i;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gp >= 0 && gp < L && gp >= lo && gp < hi) {
        v = *reinterpret_cast<const uint4*>(xrow + (size_t)gp * cin + ch);
      }
      *reinterpret_cast<uint4*>(buf_a + (ch / 8) * group_bytes + i * 16) = v;
    }
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // from lane 0, so that the compiler knows the warpgroup (and with it
  // which m64 tiles hold rows) is uniform and keeps the wgmmas asynchronous
  const int wg = __shfl_sync(0xffffffffu, warp / 4, 0);
  const int wq = warp % 4;

  float acc[P::MT][C / 2];
  int q = 0;
#pragma unroll 1
  for (int k = 0; k < 4; ++k) {
    // conv k: input buffer, output buffer, rows, first output position.
    // conv 0: A -> B at s - 12 (tile + 24 rows); conv 1: B -> A at s - 8;
    // conv 2: A -> B at s - 4; conv 3: B -> A rows 8.. at s (the residual's
    // rows), tile rows.
    const bool from_a = (k & 1) == 0;
    unsigned char* in = from_a ? buf_a : buf_b;
    unsigned char* out = from_a ? buf_b : buf_a;
    const int n_out = tile + 24 - 8 * k;
    const int pos0 = s - 12 + 4 * k;
    if (k == 3) out += 8 * 16;
    const int taps = k == 0 ? taps0 : kTaps;
    const int kdim = k == 0 ? lay.k0 : C;

#pragma unroll 1
    for (int t = 0; t < taps; ++t, ++q) {
      wgmma_wait<0>();      // this warpgroup is done with slot (q + 1) & 1
      cp_async_wait_all();  // stage q's weights (and, first, the input) are in
      fence_proxy_async();  // ... visible to the wgmmas, as are the stores
      __syncthreads();      // ... of every thread; slot (q + 1) & 1 is free
      if (q + 1 < nstages) ws.issue(q + 1);
      const int shift = (kFirst && k == 0) ? 0 : t;
      wgmma_tap_k<C>(acc, smem_u32(in) + shift * 16, group_bytes, kdim,
                     ring + (q & 1) * lay.slot_bytes, n_out, wg, t == 0);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < P::MT; ++mt) fence_regs(acc[mt]);
    mma_epilogue<C>(acc, out, group_bytes, n_out, pos0, lo, hi, wts.b[k],
                    (relu_mask >> k) & 1, k == 3 && residual != 0, wg, wq,
                    lane);
  }
  __syncthreads();

  // epilogue: max-pool by `pool` and store positions below (L / pool) * pool
  const unsigned char* out = buf_a + 8 * 16;
  const int lout = L / pool;
  const int q0 = s / pool;
  const int nq = tile / pool;
  constexpr int cv = C / 8;
  bf16* yrow = y + (size_t)r * lout * C;
  for (int e = threadIdx.x; e < nq * cv; e += kThreads) {
    const int qq = e / cv;
    const int ch = (e % cv) * 8;
    if (q0 + qq >= lout) continue;
    const unsigned char* col = out + (ch / 8) * group_bytes;
    uint4 m = *reinterpret_cast<const uint4*>(col + qq * pool * 16);
    __nv_bfloat162* mh = reinterpret_cast<__nv_bfloat162*>(&m);
    for (int j = 1; j < pool; ++j) {
      uint4 v = *reinterpret_cast<const uint4*>(col + (qq * pool + j) * 16);
      const __nv_bfloat162* vh = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int h = 0; h < 4; ++h) mh[h] = __hmax2(mh[h], vh[h]);
    }
    *reinterpret_cast<uint4*>(yrow + (size_t)(q0 + qq) * C + ch) = m;
  }
}

template <typename InT, int C, bool kFirst>
int launch_mma_c(const void* x, const ChainWeights<bf16>& wts, const int* vs,
                 const int* ve, void* y, int R, int L, int cin, int tile,
                 int pool, int relu_mask, int residual, size_t smem,
                 cudaStream_t stream) {
  using P = MmaPlan<C>;
  if (round_up(tile + 24, 64) > P::kMaxRows) return (int)cudaErrorInvalidValue;
  auto kernel = fused_chain_mma_kernel<InT, C, kFirst>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + tile - 1) / tile, R);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const InT*>(x), wts, vs,
                                           ve, static_cast<bf16*>(y), L, cin,
                                           tile, pool, relu_mask, residual);
  return (int)cudaGetLastError();
}

template <typename InT, bool kFirst>
int launch_mma(const void* x, const ChainWeights<bf16>& wts, const int* vs,
               const int* ve, void* y, int R, int L, int cin, int c, int tile,
               int pool, int relu_mask, int residual, size_t smem,
               cudaStream_t stream) {
  switch (c) {
    case 64:
      return launch_mma_c<InT, 64, kFirst>(x, wts, vs, ve, y, R, L, cin, tile,
                                           pool, relu_mask, residual, smem,
                                           stream);
    case 96:
      return launch_mma_c<InT, 96, kFirst>(x, wts, vs, ve, y, R, L, cin, tile,
                                           pool, relu_mask, residual, smem,
                                           stream);
    case 128:
      return launch_mma_c<InT, 128, kFirst>(x, wts, vs, ve, y, R, L, cin,
                                            tile, pool, relu_mask, residual,
                                            smem, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// fp32 at 64 and 96 channels: the FFMA template
// ---------------------------------------------------------------------------

// Thread (warp w, lane) owns positions p0 .. p0 + PT - 1 of a level, p0 =
// (4 w + lane / 8) PT, and the C / 8 output channels 4 (lane % 8) + 32 s ..
// + 3, s < C / 32; the block covers 32 PT positions x C channels. A ring
// slot holds one group's weights: input channels 4g .. 4g + 3, [tap][c4][C].
template <int C, int PT>
struct FfmaPlan {
  static constexpr int S = C / 32;              // float4 slices a thread
  static constexpr int kMaxRows = 32 * PT;      // positions a level can cover
  static constexpr int kSlot = kTaps * 4 * C;   // floats of one ring slot
};

__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Copy group g of a conv's (9, cin, C) weights into `slot` by cp.async and
// commit: tap t's 4 rows 4g .. 4g + 3 are 4 C contiguous floats.
template <int C>
__device__ __forceinline__ void copy_weight_group(const float* __restrict__ w,
                                                  int cin, int g, float* slot) {
  const uint32_t dst = smem_u32(slot);
  for (int e = threadIdx.x; e < kTaps * C; e += kThreads) {
    const int t = e / C;
    const int k = e % C;  // 16-byte piece of the tap's 4 C floats
    cp_async16(dst + (t * 4 * C + 4 * k) * 4,
               w + ((size_t)t * cin + 4 * g) * C + 4 * k, 16);
  }
  cp_async_commit();
}

// One k=9 conv in one pass, as conv_level computes it: out[i] <- conv(in[i ..
// i + 8]), i < n_out <= 32 PT, at global position pos0 + i. Group g + 1's
// weights land in the ring while group g's multiply-adds run; one barrier a
// group. A thread with no position (p0 >= n_out) still copies and joins
// every barrier. Ends with a barrier: the output is written, the ring free.
template <int C, int PT>
__device__ __forceinline__ void ffma_level(
    const float* __restrict__ in, int cin, float* __restrict__ out, int n_out,
    const float* __restrict__ w, const float* __restrict__ b, bool relu,
    bool add_residual, int pos0, int lo, int hi, float* ring) {
  using P = FfmaPlan<C, PT>;
  const int lane = threadIdx.x & 31;
  const int co = 4 * (lane & 7);
  const int p0 = (4 * (threadIdx.x >> 5) + (lane >> 3)) * PT;
  const bool active = p0 < n_out;
  const int groups = cin / 4;

  float4 acc[PT][P::S];
#pragma unroll
  for (int s = 0; s < P::S; ++s) {
    const float4 bias = load4(b + co + 32 * s);
#pragma unroll
    for (int j = 0; j < PT; ++j) acc[j][s] = bias;
  }

  copy_weight_group<C>(w, cin, 0, ring);
#pragma unroll 1
  for (int g = 0; g < groups; ++g) {
    cp_async_wait_all();  // group g is in (this thread's copies) ...
    __syncthreads();      // ... and every thread's; slot (g + 1) & 1 is free
    if (g + 1 < groups) {
      copy_weight_group<C>(w, cin, g + 1, ring + ((g + 1) & 1) * P::kSlot);
    }
    if (!active) continue;
    // the window of input positions p0 .. p0 + PT + 7, channels 4g .. 4g + 3,
    // clamped to the level's n_out + 8 input positions (a clamped value
    // feeds only outputs past n_out, which are never stored)
    float4 xin[PT + kTaps - 1];
#pragma unroll
    for (int i = 0; i < PT + kTaps - 1; ++i) {
      xin[i] = load4(in + min(p0 + i, n_out + 7) * cin + 4 * g);
    }
    const float* slot = ring + (g & 1) * P::kSlot + co;
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
#pragma unroll
      for (int c4 = 0; c4 < 4; ++c4) {
        float4 wv[P::S];
#pragma unroll
        for (int s = 0; s < P::S; ++s) wv[s] = load4(slot + (t * 4 + c4) * C + 32 * s);
#pragma unroll
        for (int j = 0; j < PT; ++j) {
          const float xv = lane4(xin[j + t], c4);
#pragma unroll
          for (int s = 0; s < P::S; ++s) {
            acc[j][s].x = fmaf(xv, wv[s].x, acc[j][s].x);
            acc[j][s].y = fmaf(xv, wv[s].y, acc[j][s].y);
            acc[j][s].z = fmaf(xv, wv[s].z, acc[j][s].z);
            acc[j][s].w = fmaf(xv, wv[s].w, acc[j][s].w);
          }
        }
      }
    }
  }

  // ReLU, zero outside [lo, hi), the residual, store: a quarter-warp writes
  // 128 contiguous bytes per position and slice
  if (active) {
#pragma unroll
    for (int j = 0; j < PT; ++j) {
      const int p = p0 + j;
      if (p >= n_out) break;
      const bool valid = pos0 + p >= lo && pos0 + p < hi;
#pragma unroll
      for (int s = 0; s < P::S; ++s) {
        float4 v = acc[j][s];
        if (relu) {
          v.x = fmaxf(v.x, 0.f);
          v.y = fmaxf(v.y, 0.f);
          v.z = fmaxf(v.z, 0.f);
          v.w = fmaxf(v.w, 0.f);
        }
        if (!valid) v = make_float4(0.f, 0.f, 0.f, 0.f);
        float* dst = out + p * C + co + 32 * s;
        if (add_residual) {
          const float4 r = load4(dst);
          v.x += r.x;
          v.y += r.y;
          v.z += r.z;
          v.w += r.w;
        }
        store4(dst, v);
      }
    }
  }
  __syncthreads();
}

// grid (ceil(L / tile), R); block kThreads; dynamic shared memory from
// fp32_smem_bytes: fused_chain_kernel's two buffers, then the two-slot
// weight ring.
// Blocking, masking, residual and pool as fused_chain_kernel.
template <typename InT, int C, int PT>
__global__ void __launch_bounds__(kThreads, 1)
    ffma_chain_kernel(const InT* __restrict__ x, ChainWeights<float> wts,
                      const int* __restrict__ vs, const int* __restrict__ ve,
                      float* __restrict__ y, int L, int cin, int tile,
                      int pool, int relu_mask, int residual, int mask_input,
                      float in_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cmax = cin > C ? cin : C;
  const size_t a_elems = ((size_t)(tile + 2 * kHalo) * cmax + 7) / 8 * 8;
  float* buf_a = reinterpret_cast<float*>(smem_raw);
  float* buf_b = buf_a + a_elems;
  float* ring = buf_b + (size_t)(tile + 2 * kHalo - 8) * C;

  const int r = blockIdx.y;
  const int s = blockIdx.x * tile;
  const int lo = max(vs[r], 0);
  const int hi = min(ve[r], L);

  load_tile(x, buf_a, r, s, L, cin, tile, lo, hi, mask_input, in_scale);
  __syncthreads();

  // conv 0: A (cin) -> B at s - 12; conv 1: B -> A at s - 8, kept as the
  // residual; conv 2: A -> B at s - 4; conv 3: B -> A at offset 8 (position
  // s), plus the residual in place
  ffma_level<C, PT>(buf_a, cin, buf_b, tile + 24, wts.w[0], wts.b[0],
                    relu_mask & 1, false, s - 12, lo, hi, ring);
  ffma_level<C, PT>(buf_b, C, buf_a, tile + 16, wts.w[1], wts.b[1],
                    (relu_mask >> 1) & 1, false, s - 8, lo, hi, ring);
  ffma_level<C, PT>(buf_a, C, buf_b, tile + 8, wts.w[2], wts.b[2],
                    (relu_mask >> 2) & 1, false, s - 4, lo, hi, ring);
  float* out = buf_a + 8 * C;
  ffma_level<C, PT>(buf_b, C, out, tile, wts.w[3], wts.b[3],
                    (relu_mask >> 3) & 1, residual != 0, s, lo, hi, ring);

  pool_tile(out, y, r, s, L, C, tile, pool);
}

template <typename InT, int C, int PT>
int launch_ffma(const void* x, const ChainWeights<float>& wts, const int* vs,
                const int* ve, void* y, int R, int L, int cin, int tile,
                int pool, int relu_mask, int residual, bool first, size_t smem,
                cudaStream_t stream) {
  if (tile + 24 > FfmaPlan<C, PT>::kMaxRows) return (int)cudaErrorInvalidValue;
  auto kernel = ffma_chain_kernel<InT, C, PT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + tile - 1) / tile, R);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const InT*>(x), wts, vs, ve, static_cast<float*>(y), L, cin,
      tile, pool, relu_mask, residual, first ? 0 : 1,
      sizeof(InT) == 1 ? 0.25f : 1.f);
  return (int)cudaGetLastError();
}

// fp32 shared memory: the two activation buffers, and at 64 and 96 channels
// (the FFMA template; every other width takes fused_chain_kernel) the ring.
size_t fp32_smem_bytes(int cin, int c, int tile) {
  size_t bytes = chain_smem_bytes(cin, c, tile, sizeof(float));
  if (c == 64 || c == 96) bytes += 2 * (size_t)kTaps * 4 * c * sizeof(float);
  return bytes;
}

// Makes `device` the thread's current device for one launch and sets the
// caller's device back on every return, so a launch on another card leaves
// the current device as it found it.
class DeviceScope {
 public:
  explicit DeviceScope(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) {
      err_ = cudaSetDevice(device);
      changed_ = err_ == cudaSuccess;
    }
  }
  ~DeviceScope() {
    if (changed_) cudaSetDevice(prev_);
  }
  cudaError_t error() const { return err_; }

 private:
  int prev_ = 0;
  bool changed_ = false;
  cudaError_t err_;
};

// Launch one chain. in_kind: 0 = the I/O dtype, 2 = uint8 quarter-scale
// one-hot. `smem` is the wrapper's count of the dynamic shared memory, held
// against this file's own.
template <typename InT, typename IoT>
int launch_chain(int device, const void* x, const void* const* w,
                 const void* const* b, const int* vs, const int* ve, void* y,
                 int R, int L, int cin, int c, int tile, int pool,
                 int relu_mask, int residual, bool first, size_t smem,
                 void* stream) {
  const DeviceScope scope(device);
  cudaError_t err = scope.error();
  if (err != cudaSuccess) return (int)err;
  ChainWeights<IoT> wts;
  for (int k = 0; k < 4; ++k) {
    wts.w[k] = static_cast<const IoT*>(w[k]);
    wts.b[k] = static_cast<const IoT*>(b[k]);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile % 8 || tile % pool) return (int)cudaErrorInvalidValue;
  if constexpr (sizeof(IoT) == 2) {
    if (first ? cin != 4 : (cin != 64 && cin != 96 && cin != 128)) {
      return (int)cudaErrorInvalidValue;
    }
    if (smem != MmaLayout(cin, c, tile, first).bytes()) return (int)cudaErrorInvalidValue;
    if (first) {
      return launch_mma<InT, true>(x, wts, vs, ve, y, R, L, cin, c, tile, pool,
                                   relu_mask, residual, smem, st);
    }
    return launch_mma<bf16, false>(x, wts, vs, ve, y, R, L, cin, c, tile, pool,
                                   relu_mask, residual, smem, st);
  } else {
    if (smem != fp32_smem_bytes(cin, c, tile)) return (int)cudaErrorInvalidValue;
    if (c == 64) {
      return launch_ffma<InT, 64, 8>(x, wts, vs, ve, y, R, L, cin, tile, pool,
                                     relu_mask, residual, first, smem, st);
    }
    if (c == 96) {
      return launch_ffma<InT, 96, 6>(x, wts, vs, ve, y, R, L, cin, tile, pool,
                                     relu_mask, residual, first, smem, st);
    }
    auto kernel = fused_chain_kernel<InT, IoT>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((L + tile - 1) / tile, R);
    kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const InT*>(x), wts, vs, ve, static_cast<IoT*>(y), L, cin,
        c, tile, pool, relu_mask, residual, first ? 0 : 1,
        sizeof(InT) == 1 ? 0.25f : 1.f);
    return (int)cudaGetLastError();
  }
}

}  // namespace

// io_kind: 0 = fp32, 1 = bf16. Returns a cudaError_t (0 = launched).
extern "C" int orca_fused_conv_chain(
    int device, int io_kind, const void* x, const void* w0, const void* b0,
    const void* w1, const void* b1, const void* w2, const void* b2,
    const void* w3, const void* b3, const int* vs, const int* ve, void* y,
    int R, int L, int cin, int c, int tile, int pool, int relu_mask,
    int residual, long long smem, void* stream) {
  const void* w[4] = {w0, w1, w2, w3};
  const void* b[4] = {b0, b1, b2, b3};
  if (io_kind == 1) {
    return launch_chain<bf16, bf16>(device, x, w, b, vs, ve, y, R, L, cin, c,
                                    tile, pool, relu_mask, residual, false,
                                    (size_t)smem, stream);
  }
  return launch_chain<float, float>(device, x, w, b, vs, ve, y, R, L, cin, c,
                                    tile, pool, relu_mask, residual, false,
                                    (size_t)smem, stream);
}

// in_kind: 0 = the I/O dtype, 2 = uint8 quarter-scale one-hot (x 0.25).
extern "C" int orca_fused_first_stage(
    int device, int in_kind, int io_kind, const void* x, const void* w0,
    const void* b0, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* w3, const void* b3, const int* vs,
    const int* ve, void* y, int R, int L, int cin, int c, int tile, int pool,
    int relu_mask, int residual, long long smem, void* stream) {
  const void* w[4] = {w0, w1, w2, w3};
  const void* b[4] = {b0, b1, b2, b3};
  const size_t sm = (size_t)smem;
  if (in_kind == 2) {
    if (io_kind == 1) {
      return launch_chain<uint8_t, bf16>(device, x, w, b, vs, ve, y, R, L, cin,
                                         c, tile, pool, relu_mask, residual,
                                         true, sm, stream);
    }
    return launch_chain<uint8_t, float>(device, x, w, b, vs, ve, y, R, L, cin,
                                        c, tile, pool, relu_mask, residual,
                                        true, sm, stream);
  }
  if (io_kind == 1) {
    return launch_chain<bf16, bf16>(device, x, w, b, vs, ve, y, R, L, cin, c,
                                    tile, pool, relu_mask, residual, true, sm,
                                    stream);
  }
  return launch_chain<float, float>(device, x, w, b, vs, ve, y, R, L, cin, c,
                                    tile, pool, relu_mask, residual, true, sm,
                                    stream);
}

extern "C" const char* orca_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
