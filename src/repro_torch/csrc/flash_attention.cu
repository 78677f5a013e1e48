// FedAttn flash attention for Hopper (sm_90a), bound to PyTorch through ctypes.
//
// Replaces the TPU kernel `flash_attention` of the JAX package
// (src/repro/kernels/flash_attention.py:140, body `_kernel` at :52): blockwise
// online-softmax attention with the FedAttn visibility rules built in-kernel
// from position/segment/contribution vectors — causal or bidirectional,
// Phase-I segment diagonal (`local_only`), Phase-II sparse exchange
// (`contributed`), sliding window, logit soft-cap, GQA by `h / g`.
//
// What bounds it on an H100: decode (Lq = 1) reads the whole KV cache once per
// query head for a handful of operations per byte, so it is bound by HBM bytes;
// prefill at Lq >= 1024 does O(Lq * Lk * dh) operations on O((Lq + Lk) * dh)
// bytes, so it is bound by operations. This first version computes the score
// and p*V products on CUDA cores in f32 (no wgmma, no TMA): one thread block
// per (64-row q tile, q head, batch row) loops over 64-row KV tiles staged in
// shared memory, and keeps the online softmax (m, l, acc) in registers. The
// TPU kernel carried m/l/acc in VMEM scratch across a sequential grid axis;
// here that axis is the loop inside the block. Two things keep it from doing
// needless work: a KV tile that no query row of the block can see is skipped
// before its K/V are loaded (causal future, other participants' tiles at
// Phase-I layers, the unwritten tail of a decode cache), and query rows past
// Lq do no arithmetic. Ragged Lq/Lk edges are masked here with the repo's
// sentinels (PAD_POS, KERNEL_PAD_SEGMENT); no padded copy is made in HBM.
//
// Semantics (kernels/core.py::visibility and the TPU kernel):
//   * a masked score becomes NEG_INF = -0.7 * FLT_MAX (not -inf) and its p is
//     forced to 0, so a fully-masked tile adds nothing;
//   * a fully-masked row yields 0 through l = max(l, 1e-20);
//   * soft_cap is tanh(s / c) * c after scaling;
//   * segments are used only when both are given, local_only only with
//     segments, contributed only without local_only.
//
// C interface: repro_flash_attention(...) returns cudaGetLastError() of the
// launch (0 on success); the caller allocates the output and raises on error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // KV rows per tile
constexpr int NTHREADS = 256;   // 4 threads per query row
constexpr int TPR = NTHREADS / BQ;
constexpr int COLS = BK / TPR;  // score columns per thread: cg, cg+4, ...
constexpr float NEG_INF = (float)(-0.7 * 3.4028234663852886e38);
constexpr int PAD_POS = 0x7fffffff;
constexpr int KERNEL_PAD_SEGMENT = -2;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* q_pos;
  const int* kv_pos;
  const int* q_seg;
  const int* kv_seg;
  const uint8_t* contrib;
  int B, Lq, Lk, nq, nkv;
  // row strides of the (Bv, L) vectors: 0 when shared, L when per row
  int q_pos_stride, kv_pos_stride, q_seg_stride, kv_seg_stride, contrib_stride;
  int causal, use_seg, local_only, use_contrib, has_window, window;
  float soft_cap, sm_scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ bool visible(const Params& p, int qp, int qs, int kp,
                                        int ks, int kc) {
  bool vis = p.causal ? (qp >= kp) : (kp < PAD_POS);
  if (p.has_window) vis = vis && ((long long)qp - (long long)kp < (long long)p.window);
  if (p.use_seg) {
    vis = vis && (ks >= 0);
    const bool same = qs == ks;
    if (p.local_only) {
      vis = vis && same;
    } else if (p.use_contrib) {
      vis = vis && (same || kc != 0);
    }
  }
  return vis;
}

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (DH + 1) + BK * (DH + 1) + BK * DH + BQ * (BK + 1)) +
         sizeof(int) * 3 * BK;
}

template <typename T, int DH>
__global__ void __launch_bounds__(NTHREADS) flash_attention_kernel(const Params p) {
  constexpr int QS = DH + 1;  // padded row stride of sQ/sK: no bank conflicts
  constexpr int PS = BK + 1;
  constexpr int ACC = DH / TPR;
  extern __shared__ float smem[];
  float* sQ = smem;             // [BQ][QS], pre-scaled by sm_scale
  float* sK = sQ + BQ * QS;     // [BK][QS]
  float* sV = sK + BK * QS;     // [BK][DH]
  float* sP = sV + BK * DH;     // [BQ][PS]
  int* sKpos = reinterpret_cast<int*>(sP + BQ * PS);
  int* sKseg = sKpos + BK;
  int* sKcon = sKseg + BK;

  const T* __restrict__ q = static_cast<const T*>(p.q);
  const T* __restrict__ k = static_cast<const T*>(p.k);
  const T* __restrict__ v = static_cast<const T*>(p.v);
  T* __restrict__ o = static_cast<T*>(p.o);

  const int tid = threadIdx.x;
  const int r = tid / TPR;   // query row of this thread within the tile
  const int cg = tid % TPR;  // its column group (lanes of one row are adjacent)
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.nq / p.nkv);
  const int row = q0 + r;
  const bool row_ok = row < p.Lq;

  for (int e = tid; e < BQ * DH; e += NTHREADS) {
    const int rr = e / DH, d = e % DH;
    const int qr = q0 + rr;
    float x = 0.f;
    if (qr < p.Lq) x = to_f32(q[(((size_t)b * p.Lq + qr) * p.nq + h) * DH + d]) * p.sm_scale;
    sQ[rr * QS + d] = x;
  }
  int my_qpos = 0, my_qseg = 0;
  if (row_ok) {
    my_qpos = p.q_pos[(size_t)b * p.q_pos_stride + row];
    if (p.use_seg) my_qseg = p.q_seg[(size_t)b * p.q_seg_stride + row];
  }

  float m = NEG_INF, l = 0.f;
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;

  const int n_tiles = (p.Lk + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // every read of the previous tile's shared memory is done
    if (tid < BK) {
      const int col = k0 + tid;
      const bool in = col < p.Lk;
      sKpos[tid] = in ? p.kv_pos[(size_t)b * p.kv_pos_stride + col] : PAD_POS;
      sKseg[tid] = !p.use_seg ? 0
                   : in       ? p.kv_seg[(size_t)b * p.kv_seg_stride + col]
                              : KERNEL_PAD_SEGMENT;
      sKcon[tid] = !p.use_contrib ? 1 : in ? (int)p.contrib[(size_t)b * p.contrib_stride + col] : 0;
    }
    __syncthreads();

    unsigned vis = 0;
    if (row_ok) {
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int c = cg + TPR * j;
        if (visible(p, my_qpos, my_qseg, sKpos[c], sKseg[c], sKcon[c])) vis |= 1u << j;
      }
    }
    // a tile no row of this block can see contributes exactly nothing
    if (!__syncthreads_or(vis != 0)) continue;

    for (int e = tid; e < BK * DH; e += NTHREADS) {
      const int c = e / DH, d = e % DH;
      const int col = k0 + c;
      float kx = 0.f, vx = 0.f;  // zeros past Lk: p = 0 must not meet garbage
      if (col < p.Lk) {
        const size_t off = (((size_t)b * p.Lk + col) * p.nkv + kvh) * DH + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      sK[c * QS + d] = kx;
      sV[c * DH + d] = vx;
    }
    __syncthreads();

    float s[COLS];
#pragma unroll
    for (int j = 0; j < COLS; ++j) s[j] = 0.f;
    if (vis) {
      for (int d = 0; d < DH; ++d) {
        const float qd = sQ[r * QS + d];
#pragma unroll
        for (int j = 0; j < COLS; ++j) s[j] = fmaf(qd, sK[(cg + TPR * j) * QS + d], s[j]);
      }
    }
    float tmax = NEG_INF;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      float x = s[j];
      if (p.soft_cap > 0.f) x = tanhf(x / p.soft_cap) * p.soft_cap;
      x = ((vis >> j) & 1u) ? x : NEG_INF;
      s[j] = x;
      tmax = fmaxf(tmax, x);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const float pj = ((vis >> j) & 1u) ? expf(s[j] - m_new) : 0.f;
      psum += pj;
      sP[r * PS + cg + TPR * j] = pj;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    unsigned row_vis = vis;
    row_vis |= __shfl_xor_sync(0xffffffffu, row_vis, 1);
    row_vis |= __shfl_xor_sync(0xffffffffu, row_vis, 2);
    const float corr = expf(m - m_new);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();  // the row's p values (written by its 4 lanes) are visible
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] *= corr;
    if (row_vis) {
      for (int c = 0; c < BK; ++c) {
        const float pc = sP[r * PS + c];
#pragma unroll
        for (int i = 0; i < ACC; ++i) acc[i] = fmaf(pc, sV[c * DH + cg + TPR * i], acc[i]);
      }
    }
  }

  if (row_ok) {
    const float den = fmaxf(l, 1e-20f);
    T* dst = o + (((size_t)b * p.Lq + row) * p.nq + h) * DH;
#pragma unroll
    for (int i = 0; i < ACC; ++i) dst[cg + TPR * i] = from_f32<T>(acc[i] / den);
  }
}

template <typename T, int DH>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lq + BQ - 1) / BQ, p.nq, p.B);
  flash_attention_kernel<T, DH><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, const void* q_pos,
    const void* kv_pos, const void* q_seg, const void* kv_seg, const void* contrib,
    int B, int Lq, int Lk, int nq, int nkv, int dh, int is_bf16, int q_pos_stride,
    int kv_pos_stride, int q_seg_stride, int kv_seg_stride, int contrib_stride,
    int causal, int use_seg, int local_only, int use_contrib, int has_window,
    int window, float soft_cap, float sm_scale, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_pos = static_cast<const int*>(q_pos);
  p.kv_pos = static_cast<const int*>(kv_pos);
  p.q_seg = static_cast<const int*>(q_seg);
  p.kv_seg = static_cast<const int*>(kv_seg);
  p.contrib = static_cast<const uint8_t*>(contrib);
  p.B = B;
  p.Lq = Lq;
  p.Lk = Lk;
  p.nq = nq;
  p.nkv = nkv;
  p.q_pos_stride = q_pos_stride;
  p.kv_pos_stride = kv_pos_stride;
  p.q_seg_stride = q_seg_stride;
  p.kv_seg_stride = kv_seg_stride;
  p.contrib_stride = contrib_stride;
  p.causal = causal;
  p.use_seg = use_seg;
  p.local_only = local_only;
  p.use_contrib = use_contrib;
  p.has_window = has_window;
  p.window = window;
  p.soft_cap = soft_cap;
  p.sm_scale = sm_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh == 128) {
    return (int)(is_bf16 ? launch<__nv_bfloat16, 128>(p, s) : launch<float, 128>(p, s));
  }
  if (dh == 64) {
    return (int)(is_bf16 ? launch<__nv_bfloat16, 64>(p, s) : launch<float, 64>(p, s));
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
