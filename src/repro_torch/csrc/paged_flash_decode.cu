// Paged flash-decode for Hopper (sm_90a), bound to PyTorch through ctypes.
//
// Replaces the TPU kernel `paged_flash_decode` of the JAX package
// (src/repro/kernels/flash_decode.py:153, `pallas_call` at :286): the pooled
// decode (S = 1) and speculative-verify (S = k + 1) attention of the serving
// pool, reading K/V straight from the block-paged pool through per-row page
// tables, with int8/fp8 pools dequantized at load, the full FedAttn
// visibility vocabulary, and the optional per-column attention mass that
// feeds the 'attnmass' KV selection.
//
// What bounds it on an H100: each call reads every visible K/V page once and
// does about 4 * dh operations per (query row, visible key) — a few
// operations per byte — so it is bound by HBM bytes. At the serving pool's
// shape (16 slots, 128 pages of 16 rows, 4 KV heads, dh 128, bf16) that is
// about 33.5 MB, 0.010 ms at 3.35 TB/s.
//
// What the design does about that. The TPU grid was (B, nq, P'): one program
// per (slot, query head, page) writing per-page partial (m, l, acc) — every
// KV page was read once per QUERY head, and the partials alone would be about
// 29 MB of f32 per call at the pool shape. Here one thread block serves one
// (split of the page list, KV head, slot) and all g * S query rows that read
// that KV head (g = nq / nkv), so each page is read once per KV head, and the
// partials are one (m, l, acc) per split: an online softmax runs over the
// split's pages inside the block. The split count is chosen by the caller so
// that about four blocks per SM are in flight. A page-table hole (entry
// outside [0, num_pages)) is skipped before its bytes are loaded, and so is a
// page none of whose columns any row of the block can see (the unwritten tail
// of a slot, other participants' pages at Phase-I layers): both are exactly
// neutral, since they change neither m, l nor acc. A second launch combines
// the splits (global max, correction, sum, normalisation) and turns the
// recorded scores into the normalised per-column mass. This first version
// computes on CUDA cores in f32 out of shared memory (no wgmma, no TMA, no
// asynchronous page prefetch).
//
// Semantics (kernels/core.py::visibility and the TPU kernel's `_prep`,
// `_block_attend` and `_finish`):
//   * sentinel-page columns count as PAD_POS / KERNEL_PAD_SEGMENT before any
//     visibility decision — here, they are never visible;
//   * a masked score is NEG_INF = -0.7 * FLT_MAX and its p is forced to 0;
//   * a fully-masked row yields 0 through l = max(l, 1e-20), never NaN;
//   * soft_cap is tanh(s / c) * c after scaling; query head h reads KV head
//     h / g; segments are used only when both are given, local_only only with
//     segments, contributed only without local_only; publisher_lo keeps
//     kv_pos >= lo;
//   * quantized pools: value = code * scale[page, kv head], in f32.
//
// C interface: repro_paged_flash_decode(...) launches both kernels on the
// given stream and returns cudaGetLastError() (0 on success). The caller
// allocates every output and scratch buffer.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int SPLIT_THREADS = 128;
constexpr int COMBINE_THREADS = 256;
constexpr float NEG_INF = (float)(-0.7 * 3.4028234663852886e38);
constexpr int PAD_POS = 0x7fffffff;

struct Params {
  const void* q;         // (B, S, nq, DH)
  const void* pk;        // (N, ps, nkv, DH)
  const void* pv;
  const float* k_scales;  // (N, nkv) or null
  const float* v_scales;
  const int* pages;      // (B, Pp)
  const int* q_pos;      // (Bv, S)
  const int* kv_pos;     // (Bv, Lk)
  const int* q_seg;
  const int* kv_seg;
  const uint8_t* contrib;
  const int* pub_lo;     // (Bv,)
  int B, S, nq, nkv, N, ps, Pp, Lk;
  // row strides of the vectors: 0 when shared, their length when per row
  int q_pos_stride, kv_pos_stride, q_seg_stride, kv_seg_stride, contrib_stride, pub_lo_stride;
  int causal, use_seg, local_only, use_contrib, has_window, window, has_pub;
  float soft_cap, sm_scale;
  int n_split, pages_per_split, n_chunks, return_stats;
  float* m_p;    // (n_split, B, nq, S) partial row max
  float* l_p;    // (n_split, B, nq, S) partial row mass
  float* acc_p;  // (n_split, B, nq, S, DH) partial value sums
  float* sc;     // (B, nq, S, Lk) scores of visible columns, -inf elsewhere; null without mass
  void* out;     // (B, S, nq, DH) in q's type (normalised form)
  float* m_out;  // (B, nq, S) stats form
  float* l_out;
  float* acc_out;  // (B, S, nq, DH) f32, stats form
  float* mass;   // normalised: (B, Lk); stats form: p_rel (B, nq, S, Lk)
};

__device__ __forceinline__ float load_f32(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float load_f32(const int8_t* p, size_t i) { return (float)p[i]; }
__device__ __forceinline__ float load_f32(const __nv_fp8_e4m3* p, size_t i) {
  return static_cast<float>(p[i]);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ bool visible(const Params& p, int qp, int qs, int kp, int ks, int kc,
                                        int lo) {
  bool vis = p.causal ? (qp >= kp) : (kp < PAD_POS);
  if (p.has_window) vis = vis && ((long long)qp - (long long)kp < (long long)p.window);
  if (p.has_pub) vis = vis && (kp >= lo);
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

// Shared-memory layout of one split block, in floats then ints then bytes.
struct SplitSmem {
  int R, ps, dh;
  __host__ __device__ size_t floats() const {
    return (size_t)R * (dh + 1) + (size_t)ps * (dh + 1) + (size_t)ps * dh + (size_t)R * (ps + 1) +
           (size_t)R * dh + 3 * (size_t)R;
  }
  __host__ __device__ size_t bytes(int S) const {
    return sizeof(float) * floats() + sizeof(int) * (2 * (size_t)S + 3 * (size_t)ps) +
           (size_t)R * ps;
  }
};

// One block: split `blockIdx.x` of slot `blockIdx.z`'s page list, KV head
// `blockIdx.y`, all g * S query rows of that head (row r = j * S + s reads
// query head kvh * g + j at query position s).
template <typename TQ, typename TK, int DH>
__global__ void __launch_bounds__(SPLIT_THREADS) split_kernel(const Params p) {
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int g = p.nq / p.nkv;
  const int S = p.S;
  const int R = g * S;
  const int ps = p.ps;
  const int tid = threadIdx.x;
  constexpr int QS = DH + 1;  // padded row stride: the dot products are conflict-free
  const int PS = ps + 1;

  extern __shared__ float smem[];
  float* sQ = smem;                // [R][QS], pre-scaled
  float* sK = sQ + R * QS;         // [ps][QS]
  float* sV = sK + ps * QS;        // [ps][DH]
  float* sP = sV + ps * DH;        // [R][PS] scores, then p
  float* sAcc = sP + R * PS;       // [R][DH]
  float* sM = sAcc + R * DH;       // [R]
  float* sL = sM + R;              // [R]
  float* sCorr = sL + R;           // [R]
  int* sQpos = reinterpret_cast<int*>(sCorr + R);  // [S]
  int* sQseg = sQpos + S;          // [S]
  int* sKpos = sQseg + S;          // [ps]
  int* sKseg = sKpos + ps;         // [ps]
  int* sKcon = sKseg + ps;         // [ps]
  uint8_t* sVis = reinterpret_cast<uint8_t*>(sKcon + ps);  // [R][ps]

  const TQ* __restrict__ q = static_cast<const TQ*>(p.q);
  const TK* __restrict__ pk = static_cast<const TK*>(p.pk);
  const TK* __restrict__ pv = static_cast<const TK*>(p.pv);
  const bool quant = p.k_scales != nullptr;

  for (int e = tid; e < R * DH; e += SPLIT_THREADS) {
    const int r = e / DH, d = e % DH;
    const int h = kvh * g + r / S, s = r % S;
    sQ[r * QS + d] = load_f32(q, (((size_t)b * S + s) * p.nq + h) * DH + d) * p.sm_scale;
    sAcc[e] = 0.f;
  }
  for (int r = tid; r < R; r += SPLIT_THREADS) {
    sM[r] = NEG_INF;
    sL[r] = 0.f;
  }
  for (int s = tid; s < S; s += SPLIT_THREADS) {
    sQpos[s] = p.q_pos[(size_t)b * p.q_pos_stride + s];
    sQseg[s] = p.use_seg ? p.q_seg[(size_t)b * p.q_seg_stride + s] : 0;
  }
  const int lo = p.has_pub ? p.pub_lo[(size_t)b * p.pub_lo_stride] : 0;

  const int p0 = split * p.pages_per_split;
  const int p1 = min(p.Pp, p0 + p.pages_per_split);
  for (int pi = p0; pi < p1; ++pi) {
    __syncthreads();  // the previous page's shared memory is no longer read
    const int pg = p.pages[(size_t)b * p.Pp + pi];
    const bool hole = pg < 0 || pg >= p.N;
    const int col0 = pi * ps;
    for (int c = tid; c < ps; c += SPLIT_THREADS) {
      const size_t col = (size_t)col0 + c;
      sKpos[c] = p.kv_pos[(size_t)b * p.kv_pos_stride + col];
      sKseg[c] = p.use_seg ? p.kv_seg[(size_t)b * p.kv_seg_stride + col] : 0;
      sKcon[c] = p.use_contrib ? (int)p.contrib[(size_t)b * p.contrib_stride + col] : 1;
    }
    __syncthreads();
    int any = 0;
    for (int e = tid; e < R * ps; e += SPLIT_THREADS) {
      const int r = e / ps, c = e % ps, s = r % S;
      const bool v = !hole && visible(p, sQpos[s], sQseg[s], sKpos[c], sKseg[c], sKcon[c], lo);
      sVis[e] = v;
      any |= v;
    }
    if (!__syncthreads_or(any)) {
      // nothing of this page is seen: it changes neither m, l nor acc
      if (p.sc != nullptr) {
        for (int e = tid; e < R * ps; e += SPLIT_THREADS) {
          const int r = e / ps, c = e % ps;
          const int h = kvh * g + r / S, s = r % S;
          p.sc[(((size_t)b * p.nq + h) * S + s) * p.Lk + col0 + c] = -INFINITY;
        }
      }
      continue;
    }

    const float ks = quant ? p.k_scales[(size_t)pg * p.nkv + kvh] : 1.f;
    const float vs = quant ? p.v_scales[(size_t)pg * p.nkv + kvh] : 1.f;
    for (int e = tid; e < ps * DH; e += SPLIT_THREADS) {
      const int c = e / DH, d = e % DH;
      const size_t off = (((size_t)pg * ps + c) * p.nkv + kvh) * DH + d;
      sK[c * QS + d] = load_f32(pk, off) * ks;
      sV[c * DH + d] = load_f32(pv, off) * vs;
    }
    __syncthreads();

    for (int e = tid; e < R * ps; e += SPLIT_THREADS) {
      const int r = e / ps, c = e % ps;
      float x = NEG_INF;
      if (sVis[e]) {
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < DH; ++d) dot = fmaf(sQ[r * QS + d], sK[c * QS + d], dot);
        if (p.soft_cap > 0.f) dot = tanhf(dot / p.soft_cap) * p.soft_cap;
        x = dot;
      }
      sP[r * PS + c] = x;
      if (p.sc != nullptr) {
        const int h = kvh * g + r / S, s = r % S;
        p.sc[(((size_t)b * p.nq + h) * S + s) * p.Lk + col0 + c] = sVis[e] ? x : -INFINITY;
      }
    }
    __syncthreads();

    for (int r = tid; r < R; r += SPLIT_THREADS) {
      const float m_old = sM[r];
      float tmax = NEG_INF;
      for (int c = 0; c < ps; ++c) tmax = fmaxf(tmax, sP[r * PS + c]);
      const float m_new = fmaxf(m_old, tmax);
      float psum = 0.f;
      for (int c = 0; c < ps; ++c) {
        const float pc = sVis[r * ps + c] ? expf(sP[r * PS + c] - m_new) : 0.f;
        sP[r * PS + c] = pc;
        psum += pc;
      }
      const float corr = expf(m_old - m_new);
      sL[r] = sL[r] * corr + psum;
      sM[r] = m_new;
      sCorr[r] = corr;
    }
    __syncthreads();

    for (int e = tid; e < R * DH; e += SPLIT_THREADS) {
      const int r = e / DH, d = e % DH;
      float a = sAcc[e] * sCorr[r];
      for (int c = 0; c < ps; ++c) a = fmaf(sP[r * PS + c], sV[c * DH + d], a);
      sAcc[e] = a;
    }
  }
  __syncthreads();

  const size_t base = ((size_t)split * p.B + b) * p.nq;
  for (int r = tid; r < R; r += SPLIT_THREADS) {
    const int h = kvh * g + r / S, s = r % S;
    const size_t i = (base + h) * S + s;
    p.m_p[i] = sM[r];
    p.l_p[i] = sL[r];
  }
  for (int e = tid; e < R * DH; e += SPLIT_THREADS) {
    const int r = e / DH, d = e % DH;
    const int h = kvh * g + r / S, s = r % S;
    p.acc_p[((base + h) * S + s) * DH + d] = sAcc[e];
  }
}

// One block: slot `blockIdx.x`, chunk `blockIdx.y` of its output elements and
// of its mass columns. Every block first reduces the splits' (m, l) for all
// nq * S rows of the slot (cheap), then combines its chunk.
template <typename TQ>
__global__ void __launch_bounds__(COMBINE_THREADS) combine_kernel(const Params p, int dh) {
  const int b = blockIdx.x, chunk = blockIdx.y;
  const int rows = p.nq * p.S;
  const int tid = threadIdx.x;
  extern __shared__ float smem[];
  float* sMg = smem;        // [rows]
  float* sLg = smem + rows;  // [rows]

  for (int row = tid; row < rows; row += COMBINE_THREADS) {
    float mg = NEG_INF;
    for (int i = 0; i < p.n_split; ++i)
      mg = fmaxf(mg, p.m_p[((size_t)i * p.B + b) * rows + row]);
    float lg = 0.f;
    for (int i = 0; i < p.n_split; ++i) {
      const size_t j = ((size_t)i * p.B + b) * rows + row;
      lg += p.l_p[j] * expf(p.m_p[j] - mg);
    }
    sMg[row] = mg;
    sLg[row] = lg;
    if (p.return_stats && chunk == 0) {
      p.m_out[(size_t)b * rows + row] = mg;
      p.l_out[(size_t)b * rows + row] = lg;
    }
  }
  __syncthreads();

  const int total = rows * dh;
  const int per = (total + p.n_chunks - 1) / p.n_chunks;
  const int e1 = min(total, (chunk + 1) * per);
  for (int e = chunk * per + tid; e < e1; e += COMBINE_THREADS) {
    const int row = e / dh, d = e % dh;
    const int h = row / p.S, s = row % p.S;
    float a = 0.f;
    for (int i = 0; i < p.n_split; ++i) {
      const size_t j = ((size_t)i * p.B + b) * rows + row;
      a += p.acc_p[j * dh + d] * expf(p.m_p[j] - sMg[row]);
    }
    const size_t o = (((size_t)b * p.S + s) * p.nq + h) * dh + d;
    if (p.return_stats) {
      p.acc_out[o] = a;
    } else {
      static_cast<TQ*>(p.out)[o] = from_f32<TQ>(a / fmaxf(sLg[row], 1e-20f));
    }
  }

  if (p.sc == nullptr) return;
  const int cper = (p.Lk + p.n_chunks - 1) / p.n_chunks;
  const int c1 = min(p.Lk, (chunk + 1) * cper);
  for (int col = chunk * cper + tid; col < c1; col += COMBINE_THREADS) {
    float msum = 0.f;
    for (int row = 0; row < rows; ++row) {
      const size_t j = ((size_t)b * rows + row) * p.Lk + col;
      const float pr = expf(p.sc[j] - sMg[row]);  // exp(-inf) = 0 off the visible columns
      if (p.return_stats) {
        p.mass[j] = pr;
      } else {
        msum += pr / fmaxf(sLg[row], 1e-20f);
      }
    }
    if (!p.return_stats) p.mass[(size_t)b * p.Lk + col] = msum;
  }
}

template <typename TQ, typename TK, int DH>
cudaError_t launch_split(const Params& p, cudaStream_t stream) {
  const SplitSmem lay{(p.nq / p.nkv) * p.S, p.ps, DH};
  const size_t smem = lay.bytes(p.S);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        split_kernel<TQ, TK, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(p.n_split, p.nkv, p.B);
  split_kernel<TQ, TK, DH><<<grid, SPLIT_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename TQ, int DH>
cudaError_t launch_kv(const Params& p, int kv_type, cudaStream_t stream) {
  switch (kv_type) {
    case 0: return launch_split<TQ, float, DH>(p, stream);
    case 1: return launch_split<TQ, __nv_bfloat16, DH>(p, stream);
    case 2: return launch_split<TQ, int8_t, DH>(p, stream);
    case 3: return launch_split<TQ, __nv_fp8_e4m3, DH>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TQ>
cudaError_t launch_all(const Params& p, int dh, int kv_type, cudaStream_t stream) {
  cudaError_t err = dh == 128  ? launch_kv<TQ, 128>(p, kv_type, stream)
                    : dh == 64 ? launch_kv<TQ, 64>(p, kv_type, stream)
                               : cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  const size_t smem = 2 * sizeof(float) * (size_t)p.nq * p.S;
  const dim3 grid(p.B, p.n_chunks);
  combine_kernel<TQ><<<grid, COMBINE_THREADS, smem, stream>>>(p, dh);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_paged_flash_decode(
    const void* q, const void* pk, const void* pv, const void* k_scales, const void* v_scales,
    const void* pages, const void* q_pos, const void* kv_pos, const void* q_seg,
    const void* kv_seg, const void* contrib, const void* pub_lo, void* m_p, void* l_p,
    void* acc_p, void* sc, void* out, void* m_out, void* l_out, void* acc_out, void* mass,
    int B, int S, int nq, int nkv, int N, int ps, int Pp, int dh, int q_type, int kv_type,
    int q_pos_stride, int kv_pos_stride, int q_seg_stride, int kv_seg_stride,
    int contrib_stride, int pub_lo_stride, int causal, int use_seg, int local_only,
    int use_contrib, int has_window, int window, int has_pub, int n_split,
    int pages_per_split, int n_chunks, int return_stats, float soft_cap, float sm_scale,
    void* stream) {
  Params p;
  p.q = q;
  p.pk = pk;
  p.pv = pv;
  p.k_scales = static_cast<const float*>(k_scales);
  p.v_scales = static_cast<const float*>(v_scales);
  p.pages = static_cast<const int*>(pages);
  p.q_pos = static_cast<const int*>(q_pos);
  p.kv_pos = static_cast<const int*>(kv_pos);
  p.q_seg = static_cast<const int*>(q_seg);
  p.kv_seg = static_cast<const int*>(kv_seg);
  p.contrib = static_cast<const uint8_t*>(contrib);
  p.pub_lo = static_cast<const int*>(pub_lo);
  p.B = B;
  p.S = S;
  p.nq = nq;
  p.nkv = nkv;
  p.N = N;
  p.ps = ps;
  p.Pp = Pp;
  p.Lk = Pp * ps;
  p.q_pos_stride = q_pos_stride;
  p.kv_pos_stride = kv_pos_stride;
  p.q_seg_stride = q_seg_stride;
  p.kv_seg_stride = kv_seg_stride;
  p.contrib_stride = contrib_stride;
  p.pub_lo_stride = pub_lo_stride;
  p.causal = causal;
  p.use_seg = use_seg;
  p.local_only = local_only;
  p.use_contrib = use_contrib;
  p.has_window = has_window;
  p.window = window;
  p.has_pub = has_pub;
  p.soft_cap = soft_cap;
  p.sm_scale = sm_scale;
  p.n_split = n_split;
  p.pages_per_split = pages_per_split;
  p.n_chunks = n_chunks;
  p.return_stats = return_stats;
  p.m_p = static_cast<float*>(m_p);
  p.l_p = static_cast<float*>(l_p);
  p.acc_p = static_cast<float*>(acc_p);
  p.sc = static_cast<float*>(sc);
  p.out = out;
  p.m_out = static_cast<float*>(m_out);
  p.l_out = static_cast<float*>(l_out);
  p.acc_out = static_cast<float*>(acc_out);
  p.mass = static_cast<float*>(mass);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_type == 1) return (int)launch_all<__nv_bfloat16>(p, dh, kv_type, s);
  if (q_type == 0) return (int)launch_all<float>(p, dh, kv_type, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
