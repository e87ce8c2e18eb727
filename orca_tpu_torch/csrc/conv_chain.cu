// Fused k=9 conv chains of the bp-resolution encoder tower, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of orca_tpu/ops/pallas/conv1d.py:
//   * fused_first_stage_packed (encoder stage 0): the one-hot 4->64 conv, then
//     three 64->64 convs, residual from the first chain conv, pool-4 epilogue;
//   * fused_conv_chain_packed (encoder stages 1-6): four k=9 convs, residual
//     from the second conv (none at the last stage), the next stage's
//     max-pool (4, 5, 5, 5, 2) in the epilogue.
// Both are the same chain of four k=9 "same" convs, so one kernel template
// serves both; the first stage reads a uint8 quarter-scale (or float) one-hot
// input and does not mask it, the chain stages mask their input.
//
// Semantics per conv: fp32 accumulation plus bias, ReLU if the conv has one,
// zero every position outside the row's [vs, ve) (and outside [0, L)), round
// to the I/O dtype (bf16 or fp32). Output = last conv + residual conv, then
// max-pool by `pool` (floor length).
//
// Design (simple, right first):
//   * one block per (row, tile of T output positions); T is a multiple of the
//     pool, so pool windows never straddle tiles;
//   * the tile plus a 16-position halo per side (4 convs x 4) is loaded into
//     shared memory, zero outside [0, L);
//   * each conv runs over a range that shrinks by 4 per side, ping-ponging
//     between two shared buffers kept in the I/O dtype; the residual conv's
//     output stays in its buffer and the last conv adds into it in place;
//   * the max-pool epilogue reads that buffer and stores the pooled tile.
//
// Bound: at the encoder's shapes (64-128 channels, 4.2 Mb rows) the chain
// does ~2*9*C*C operations per position per conv against a few bytes of
// traffic per position, so it is bound by operations, not bytes. This simple
// design gives up the tensor cores (every multiply-add runs on the CUDA cores
// in fp32) and reads the weights through L1/L2 rather than staging them in
// shared memory; wgmma, TMA and staged weights are later work.

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

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(q[0]);
  const float2 b = __bfloat1622float2(q[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float4 load4(const uint8_t* p) {
  const uchar4 u = *reinterpret_cast<const uchar4*>(p);
  return make_float4(u.x, u.y, u.z, u.w);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v.x, v.y);
  q[1] = __floats2bfloat162_rn(v.z, v.w);
}

__device__ __forceinline__ float round_io(float v, float*) { return v; }

__device__ __forceinline__ float round_io(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float4 max4(float4 a, float4 b) {
  return make_float4(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z),
                     fmaxf(a.w, b.w));
}

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
// chain_smem_bytes. relu_mask bit k: conv k has a ReLU. residual: add the
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

  // level 0: input positions [s - 16, s + tile + 16), zero outside [0, L)
  // (and outside [lo, hi) when the input is masked)
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
    store4(buf_a + i * cin + ch, v);
  }
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

  // epilogue: max-pool by `pool` and store positions below (L / pool) * pool
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

size_t chain_smem_bytes(int cin, int c, int tile, size_t elem) {
  const int cmax = cin > c ? cin : c;
  const size_t a_elems = ((size_t)(tile + 2 * kHalo) * cmax + 7) / 8 * 8;
  const size_t b_elems = (size_t)(tile + 2 * kHalo - 8) * c;
  return (a_elems + b_elems) * elem;
}

template <typename InT, typename IoT>
int launch_chain(int device, const void* x, const void* const* w,
                 const void* const* b, const int* vs, const int* ve, void* y,
                 int R, int L, int cin, int c, int tile, int pool,
                 int relu_mask, int residual, int mask_input, float in_scale,
                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  ChainWeights<IoT> wts;
  for (int k = 0; k < 4; ++k) {
    wts.w[k] = static_cast<const IoT*>(w[k]);
    wts.b[k] = static_cast<const IoT*>(b[k]);
  }
  const size_t smem = chain_smem_bytes(cin, c, tile, sizeof(IoT));
  auto kernel = fused_chain_kernel<InT, IoT>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + tile - 1) / tile, R);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const InT*>(x), wts, vs, ve, static_cast<IoT*>(y), L, cin, c,
      tile, pool, relu_mask, residual, mask_input, in_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// io_kind: 0 = fp32, 1 = bf16. Returns a cudaError_t (0 = launched).
extern "C" int orca_fused_conv_chain(
    int device, int io_kind, const void* x, const void* w0, const void* b0,
    const void* w1, const void* b1, const void* w2, const void* b2,
    const void* w3, const void* b3, const int* vs, const int* ve, void* y,
    int R, int L, int cin, int c, int tile, int pool, int relu_mask,
    int residual, void* stream) {
  const void* w[4] = {w0, w1, w2, w3};
  const void* b[4] = {b0, b1, b2, b3};
  if (io_kind == 1) {
    return launch_chain<__nv_bfloat16, __nv_bfloat16>(
        device, x, w, b, vs, ve, y, R, L, cin, c, tile, pool, relu_mask,
        residual, 1, 1.f, stream);
  }
  return launch_chain<float, float>(device, x, w, b, vs, ve, y, R, L, cin, c,
                                    tile, pool, relu_mask, residual, 1, 1.f,
                                    stream);
}

// in_kind: 0 = the I/O dtype, 2 = uint8 quarter-scale one-hot (x 0.25).
extern "C" int orca_fused_first_stage(
    int device, int in_kind, int io_kind, const void* x, const void* w0,
    const void* b0, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* w3, const void* b3, const int* vs,
    const int* ve, void* y, int R, int L, int cin, int c, int tile, int pool,
    int relu_mask, int residual, void* stream) {
  const void* w[4] = {w0, w1, w2, w3};
  const void* b[4] = {b0, b1, b2, b3};
  if (in_kind == 2) {
    if (io_kind == 1) {
      return launch_chain<uint8_t, __nv_bfloat16>(
          device, x, w, b, vs, ve, y, R, L, cin, c, tile, pool, relu_mask,
          residual, 0, 0.25f, stream);
    }
    return launch_chain<uint8_t, float>(device, x, w, b, vs, ve, y, R, L, cin,
                                        c, tile, pool, relu_mask, residual, 0,
                                        0.25f, stream);
  }
  if (io_kind == 1) {
    return launch_chain<__nv_bfloat16, __nv_bfloat16>(
        device, x, w, b, vs, ve, y, R, L, cin, c, tile, pool, relu_mask,
        residual, 0, 1.f, stream);
  }
  return launch_chain<float, float>(device, x, w, b, vs, ve, y, R, L, cin, c,
                                    tile, pool, relu_mask, residual, 0, 1.f,
                                    stream);
}

extern "C" const char* orca_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
