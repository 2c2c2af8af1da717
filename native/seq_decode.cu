// Batched stack and Fano decoders, one frame per thread.
//
// Each thread walks whole frames through the sequential search of the C
// reference (AWGN-channel/{stack,fano}-decoder.c and the BSC twins): the
// walks are ports of native/convcodes_native.c, which is bit-exact against
// tests/golden_model.py.  A thread that finishes a frame takes the next
// undecoded frame id from a global counter, so a thread pays for the mean
// walk and not for the slowest frame of a batch.
//
// The file builds two ways from the same source:
//   nvcc (sm_90a): the CUDA kernels behind XLA FFI targets on the GPU;
//   g++:           the same per-frame walks behind XLA FFI targets on the
//                  CPU, so the tests exercise this code without a GPU.
// The soft metric 1 + w*d must round the product before the add, as the
// reference does: nvcc builds with -fmad=false and g++ with
// -ffp-contract=off, and the product goes through mul_rn below.

#include <cstdint>
#include <cstring>

#include "xla/ffi/api/ffi.h"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__
#else
#define HD
#endif

namespace ffi = xla::ffi;

namespace {

constexpr int kMaxT = 256;        // longest frame (block + tail) a thread holds
constexpr int kStackDepth = 64;   // ops/stack.STACK_DEPTH
constexpr int kMaxPolys = 8;
constexpr int kMaxWords = kMaxT / 32;

struct Code {
  int K, L, T, M, symlen, compat;
  uint32_t quirk;
  uint32_t polys[kMaxPolys];
};

HD inline int parity32(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __popc(x) & 1;
#else
  return __builtin_parity(x);
#endif
}

HD inline int popcount32(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

HD inline float mul_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

// Expected symbol for register r (K bits, newest input at bit K-1), with
// the reference's compat-parity quirk.
HD inline int expected_symbol(const Code& c, uint32_t r) {
  int sym = 0;
  for (int n = 0; n < c.symlen; ++n) {
    uint32_t x = r & c.polys[n];
    int bit = parity32(x);
    if (c.compat && parity32(x & c.quirk)) bit = 0;
    sym = (sym << 1) | bit;
  }
  return sym;
}

// Transition metric of expected symbol es at position t of one frame.
struct SoftMetric {
  const float* dists;  // [T, M]
  float w;
  int M;
  HD float operator()(int t, int es) const {
    return 1.0f + mul_rn(w, dists[t * M + es]);
  }
};

struct HardMetric {
  const int32_t* rx;   // [T]
  int32_t bm0, bm1;
  int symlen;
  HD int32_t operator()(int t, int es) const {
    int h = popcount32(static_cast<uint32_t>(es ^ rx[t]));
    return h * bm1 + (symlen - h) * bm0;
  }
};

// ---- stack decoder (convcodes_native.c cc_stack_*_blocks) -------------

template <typename MT>
struct StackPath {
  int32_t nii;
  uint32_t state;
  MT metric;
};

template <typename MT>
HD inline int stack_argmax(const StackPath<MT>* a, int n) {
  int b = 0;
  for (int i = 1; i < n; ++i)
    if (a[i].metric > a[b].metric) b = i;
  return b;
}

template <typename MT>
HD inline int stack_argmin(const StackPath<MT>* a, int n) {
  int b = 0;
  for (int i = 1; i < n; ++i)
    if (a[i].metric < a[b].metric) b = i;
  return b;
}

template <typename MT, typename TM>
HD void stack_frame(const Code& c, const TM& tm_of, int8_t* out) {
  StackPath<MT> paths[kStackDepth];
  uint32_t bits[kStackDepth][kMaxWords];
  const int nw = (c.T + 31) / 32;
  int np = 1;
  paths[0].nii = 0;
  paths[0].state = 0;
  paths[0].metric = MT(0);
  for (int w = 0; w < nw; ++w) bits[0][w] = 0;
  int cur = 0;
  for (int widx = 1; widx <= c.T; ++widx) {
    cur = stack_argmax(paths, np);
    while (paths[cur].nii != widx) {
      StackPath<MT>* pp = &paths[cur];
      uint32_t ns[2];
      MT tm[2];
      for (int i = 0; i < 2; ++i) {
        uint32_t reg = pp->state | (static_cast<uint32_t>(i) << (c.K - 1));
        ns[i] = reg >> 1;
        tm[i] = tm_of(pp->nii, expected_symbol(c, reg));
      }
      int newi = np < kStackDepth ? np++ : stack_argmin(paths, np);
      StackPath<MT>* q = &paths[newi];
      q->nii = pp->nii;
      q->state = pp->state;
      q->metric = pp->metric;
      if (newi != cur)
        for (int w = 0; w < nw; ++w) bits[newi][w] = bits[cur][w];
      // extend the original with input 0, the duplicate with input 1 — in
      // sequence, so the alias case (newi == cur) matches the reference
      {
        int oi = pp->nii;
        pp->nii += 1;
        pp->state = ns[0];
        pp->metric = pp->metric + tm[0];
        bits[cur][oi >> 5] &= ~(1u << (oi & 31));
      }
      {
        int oi = q->nii;
        q->nii += 1;
        q->state = ns[1];
        q->metric = q->metric + tm[1];
        bits[newi][oi >> 5] |= 1u << (oi & 31);
      }
      cur = stack_argmax(paths, np);
    }
  }
  for (int t = 0; t < c.L; ++t)
    out[t] = static_cast<int8_t>((bits[cur][t >> 5] >> (t & 31)) & 1);
}

// ---- Fano decoder (convcodes_native.c cc_fano_*_blocks) ---------------

template <typename MT>
struct FanoNode {
  uint32_t state, succ[2];
  MT metric, tm[2];
  int8_t selected, decoded;
};

template <typename MT, typename TM>
HD inline void fano_compute(const Code& c, FanoNode<MT>* n, int t,
                            const TM& tm_of) {
  uint32_t sc[2];
  MT tv[2];
  for (int i = 0; i < 2; ++i) {
    uint32_t reg = n->state | (static_cast<uint32_t>(i) << (c.K - 1));
    sc[i] = reg >> 1;
    tv[i] = tm_of(t, expected_symbol(c, reg));
  }
  int swap = tv[0] < tv[1];  // strict: best branch first
  n->succ[0] = sc[swap];
  n->succ[1] = sc[1 - swap];
  n->tm[0] = tv[swap];
  n->tm[1] = tv[1 - swap];
  n->selected = 0;
  n->decoded = static_cast<int8_t>(swap);
}

template <typename MT, typename TM>
HD void fano_frame(const Code& c, const TM& tm_of, MT delta,
                   int64_t timeout_per_bit, int8_t* out) {
  FanoNode<MT> nodes[kMaxT];
  for (int t = 0; t < c.T; ++t) {
    nodes[t].state = 0;
    nodes[t].metric = MT(0);
    nodes[t].selected = 0;
    nodes[t].decoded = 0;
  }
  MT threshold = MT(0);
  int64_t timeout = timeout_per_bit * c.T;
  int cur = 0, ignore = 0, done = 0;
  for (int received = 1; received <= c.T && !done; ++received) {
    if (ignore) continue;
    fano_compute(c, &nodes[cur], cur, tm_of);
    int moved_out = 0;
    while (timeout != 0) {
      timeout--;
      FanoNode<MT>* n = &nodes[cur];
      MT ms = n->metric + n->tm[n->selected];
      if (ms >= threshold) {
        if (n->metric < threshold + delta)
          while (ms >= threshold + delta) threshold = threshold + delta;
        int nxt = cur + 1;
        if (nxt == c.T) {
          done = 1;
          break;
        }
        nodes[nxt].state = n->succ[n->selected];
        nodes[nxt].metric = ms;
        cur = nxt;
        if (cur == received) {
          moved_out = 1;
          break;
        }
        fano_compute(c, &nodes[cur], cur, tm_of);
      } else {
        for (;;) {
          if (cur == 0 || nodes[cur - 1].metric < threshold) {
            threshold = threshold - delta;
            if (nodes[cur].selected != 0) {
              nodes[cur].selected = 0;
              nodes[cur].decoded ^= 1;
            }
            break;
          }
          cur--;
          if (nodes[cur].selected == 0) {
            nodes[cur].selected = 1;
            nodes[cur].decoded ^= 1;
            break;
          }
        }
      }
    }
    if (done) break;
    if (!moved_out && timeout == 0) {
      if (received == c.T) break;
      ignore = 1;
    }
  }
  for (int t = 0; t < c.L; ++t) out[t] = nodes[t].decoded;
}

// ---- one frame, dispatched on decoder and metric ----------------------

struct Params {
  Code code;
  float weight;        // soft metric weight
  int32_t bm0, bm1;    // hard bit metrics
  float fdelta;        // Fano threshold step, soft
  int32_t idelta;      // Fano threshold step, hard
  int64_t timeout_per_bit;
};

template <bool kFano, bool kSoft>
HD void decode_frame(const Params& p, const void* syms, int64_t f,
                     int8_t* bits_out) {
  const Code& c = p.code;
  int8_t* out = bits_out + f * c.L;
  if constexpr (kSoft) {
    SoftMetric tm{static_cast<const float*>(syms) + f * c.T * c.M, p.weight,
                  c.M};
    if constexpr (kFano)
      fano_frame<float>(c, tm, p.fdelta, p.timeout_per_bit, out);
    else
      stack_frame<float>(c, tm, out);
  } else {
    HardMetric tm{static_cast<const int32_t*>(syms) + f * c.T, p.bm0, p.bm1,
                  c.symlen};
    if constexpr (kFano)
      fano_frame<int32_t>(c, tm, p.idelta, p.timeout_per_bit, out);
    else
      stack_frame<int32_t>(c, tm, out);
  }
}

#ifdef __CUDACC__
template <bool kFano, bool kSoft>
__global__ void decode_kernel(Params p, const void* syms, int32_t n,
                              int8_t* bits_out, int32_t* next) {
  for (;;) {
    int32_t f = atomicAdd(next, 1);
    if (f >= n) return;
    decode_frame<kFano, kSoft>(p, syms, f, bits_out);
  }
}
#endif

ffi::Error make_params(ffi::Span<const int64_t> polys, int32_t K, int32_t L,
                       int32_t symlen, bool compat, float weight, int32_t bm0,
                       int32_t bm1, float fdelta, int32_t idelta,
                       int64_t timeout_per_bit, Params* p) {
  Code& c = p->code;
  c.K = K;
  c.L = L;
  c.T = L + K - 1;
  c.symlen = symlen;
  c.M = 1 << symlen;
  c.compat = compat ? 1 : 0;
  if (c.T > kMaxT || symlen > kMaxPolys ||
      polys.size() != static_cast<size_t>(symlen) || K < 2 || K > 32)
    return ffi::Error::InvalidArgument("sequential decoder: unsupported code");
  uint32_t quirk = 0;  // bits {4,12,...,60} of the 64-bit register, low form
  for (int j = 4; j <= 60; j += 8) {
    int b = j - 64 + K;
    if (b >= 0 && b < K) quirk |= 1u << b;
  }
  c.quirk = quirk;
  for (int i = 0; i < symlen; ++i) c.polys[i] = static_cast<uint32_t>(polys[i]);
  p->weight = weight;
  p->bm0 = bm0;
  p->bm1 = bm1;
  p->fdelta = fdelta;
  p->idelta = idelta;
  p->timeout_per_bit = timeout_per_bit;
  return ffi::Error::Success();
}

template <bool kFano, bool kSoft>
ffi::Error decode_cpu(ffi::AnyBuffer syms, ffi::Result<ffi::Buffer<ffi::S8>> bits,
                      ffi::Result<ffi::Buffer<ffi::S32>> /*next: GPU only*/,
                      ffi::Span<const int64_t> polys, int32_t K, int32_t L,
                      int32_t symlen, bool compat, float weight, int32_t bm0,
                      int32_t bm1, float fdelta, int32_t idelta,
                      int64_t timeout_per_bit) {
  Params p;
  ffi::Error err = make_params(polys, K, L, symlen, compat, weight, bm0, bm1,
                               fdelta, idelta, timeout_per_bit, &p);
  if (err.failure()) return err;
  const int64_t n = bits->dimensions()[0];
  for (int64_t f = 0; f < n; ++f)
    decode_frame<kFano, kSoft>(p, syms.untyped_data(), f, bits->typed_data());
  return ffi::Error::Success();
}

#ifdef __CUDACC__
template <bool kFano, bool kSoft>
ffi::Error decode_cuda(cudaStream_t stream, ffi::AnyBuffer syms,
                       ffi::Result<ffi::Buffer<ffi::S8>> bits,
                       ffi::Result<ffi::Buffer<ffi::S32>> next,
                       ffi::Span<const int64_t> polys, int32_t K, int32_t L,
                       int32_t symlen, bool compat, float weight, int32_t bm0,
                       int32_t bm1, float fdelta, int32_t idelta,
                       int64_t timeout_per_bit) {
  Params p;
  ffi::Error err = make_params(polys, K, L, symlen, compat, weight, bm0, bm1,
                               fdelta, idelta, timeout_per_bit, &p);
  if (err.failure()) return err;
  const int64_t n = bits->dimensions()[0];
  if (n == 0) return ffi::Error::Success();
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  // enough resident threads to fill every SM; each pulls frames until
  // the counter runs past n
  constexpr int kThreads = 128;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  const int64_t fill = static_cast<int64_t>(sms) * (2048 / kThreads);
  if (blocks > fill) blocks = fill;
  cudaMemsetAsync(next->typed_data(), 0, sizeof(int32_t), stream);
  decode_kernel<kFano, kSoft><<<static_cast<int>(blocks), kThreads, 0, stream>>>(
      p, syms.untyped_data(), static_cast<int32_t>(n), bits->typed_data(),
      next->typed_data());
  cudaError_t last = cudaGetLastError();
  if (last != cudaSuccess)
    return ffi::Error::Internal(cudaGetErrorString(last));
  return ffi::Error::Success();
}
#endif

}  // namespace

#define SEQ_ATTRS                               \
  .Attr<ffi::Span<const int64_t>>("polys")      \
      .Attr<int32_t>("K")                       \
      .Attr<int32_t>("L")                       \
      .Attr<int32_t>("symlen")                  \
      .Attr<bool>("compat")                     \
      .Attr<float>("weight")                    \
      .Attr<int32_t>("bm0")                     \
      .Attr<int32_t>("bm1")                     \
      .Attr<float>("fdelta")                    \
      .Attr<int32_t>("idelta")                  \
      .Attr<int64_t>("timeout_per_bit")

#define DEFINE_CPU(NAME, FANO, SOFT)                                    \
  XLA_FFI_DEFINE_HANDLER_SYMBOL(NAME, (decode_cpu<FANO, SOFT>),         \
                                ffi::Ffi::Bind()                        \
                                    .Arg<ffi::AnyBuffer>()              \
                                    .Ret<ffi::Buffer<ffi::S8>>()        \
                                    .Ret<ffi::Buffer<ffi::S32>>()       \
                                    SEQ_ATTRS);

DEFINE_CPU(SeqStackSoftCpu, false, true)
DEFINE_CPU(SeqStackHardCpu, false, false)
DEFINE_CPU(SeqFanoSoftCpu, true, true)
DEFINE_CPU(SeqFanoHardCpu, true, false)

#ifdef __CUDACC__
#define DEFINE_CUDA(NAME, FANO, SOFT)                                   \
  XLA_FFI_DEFINE_HANDLER_SYMBOL(                                        \
      NAME, (decode_cuda<FANO, SOFT>),                                  \
      ffi::Ffi::Bind()                                                  \
          .Ctx<ffi::PlatformStream<cudaStream_t>>()                     \
          .Arg<ffi::AnyBuffer>()                                        \
          .Ret<ffi::Buffer<ffi::S8>>()                                  \
          .Ret<ffi::Buffer<ffi::S32>>()                                 \
          SEQ_ATTRS);

DEFINE_CUDA(SeqStackSoftCuda, false, true)
DEFINE_CUDA(SeqStackHardCuda, false, false)
DEFINE_CUDA(SeqFanoSoftCuda, true, true)
DEFINE_CUDA(SeqFanoHardCuda, true, false)
#endif
