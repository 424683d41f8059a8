// Banded gap-affine POA fill for Hopper, called from JAX through the FFI.
//
// One thread block scores one read.  The block walks the graph's ranks in
// topological order inside a single launch; its threads run across the
// band's lanes (LPT contiguous lanes each).  The M and D rings -- W rows
// of Wb lanes, slots assigned by the liveness colouring of DeviceGraph --
// live in shared memory, so a rank's predecessor rows never leave the SM.
//
// The recurrence, tables and edge rules are those of the XLA body
// (poasta_tpu/ops/banded_fill.py, ``xla_banded_exec``), which is the
// plain reference for this kernel: same prepared tables, same int32
// arithmetic, bit-equal results.
//
//   D(j)  = min(min_p M_p(j) + o + e, min_p D_p(j) + e)
//   A(j)  = min(min_p M_p(j-1) + (q(j) == sym ? 0 : x), D(j))
//   I(j)  = min_{k<j} (A(k) - e*k) + o + e*j          (block prefix-min)
//   M(j)  = min(A(j), I(j))
//
// Predecessor rows are read at window offset delta = w_r - w_p; lanes
// outside [0, Wb) read INF.  Drifting windows (DRIFT) shift each read's
// frame right by sig(r) = 128*floor(nbs*s_r/S); a row written at frame
// sig_w is read at the current frame through the offset sig - sig_w,
// which reproduces the XLA body's 128-lane ring rolls without moving data.
// Ends-free spans (EF) keep a running min over permitted ranks and the
// query-end window [jlo, len] instead of the end-rank lane.

#include <cstddef>
#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kInf = 1 << 28;        // ops/dp_rows.INF
constexpr int kScanIdentity = 1 << 30;  // above every tilted value

struct FillParams {
  int n_nodes, P, W, Wb, LQ;
  int o, e, x;
  int S, mq, n_min;
  int free_start;
};

template <int LPT, bool DRIFT, bool EF>
__global__ void __launch_bounds__(1024) banded_fill_kernel(
    FillParams p, const int* __restrict__ symbols,
    const int* __restrict__ pred_slots, const int* __restrict__ pred_valid,
    const int* __restrict__ pred_wstarts, const int* __restrict__ wstarts,
    const int* __restrict__ wslots, const int* __restrict__ end_ok,
    const int* __restrict__ s_ranks, const int* __restrict__ q,
    const int* __restrict__ lengths, const int* __restrict__ jlo,
    int* __restrict__ out) {
  extern __shared__ int shmem[];
  const int Wb = p.Wb;
  int* m_ring = shmem;
  int* d_ring = shmem + p.W * Wb;
  int* warp_min = d_ring + p.W * Wb;  // 32 entries
  int* slot_sig = warp_min + 32;      // W entries (DRIFT)

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int j0 = t * LPT;
  const int len = lengths[b];
  const int* qrow = q + static_cast<size_t>(b) * p.LQ;
  const int end_rank = p.n_nodes - 1;
  const int nbs = DRIFT ? max(len - p.n_min + 64, 0) / 128 : 0;
  const int jlo_b = EF ? jlo[b] : 0;

  for (int i = t; i < 2 * p.W * Wb; i += blockDim.x) shmem[i] = kInf;
  if (DRIFT) {
    for (int i = t; i < p.W; i += blockDim.x) slot_sig[i] = 0;
  }
  if (!EF && t == 0) out[b] = kInf;
  int best = kInf;
  __syncthreads();

  for (int r = 0; r < p.n_nodes; ++r) {
    const int w_r = __ldg(wstarts + r);
    const int sym = __ldg(symbols + r);
    const int sig = DRIFT ? 128 * ((nbs * __ldg(s_ranks + r)) / p.S) : 0;
    const int jbase = w_r + sig + j0;  // global offset of this thread's lane 0

    // pm[i] = min over predecessors of M at lane j0 - 1 + i; pd[i] of D at
    // lane j0 + i
    int pm[LPT + 1];
    int pd[LPT];
#pragma unroll
    for (int i = 0; i <= LPT; ++i) pm[i] = kInf;
#pragma unroll
    for (int i = 0; i < LPT; ++i) pd[i] = kInf;
    for (int k = 0; k < p.P; ++k) {
      const int idx = r * p.P + k;
      if (!__ldg(pred_valid + idx)) continue;
      const int slot = __ldg(pred_slots + idx);
      const int delta = w_r - __ldg(pred_wstarts + idx);
      const int shift = DRIFT ? sig - slot_sig[slot] : 0;
      const int* mrow = m_ring + slot * Wb;
      const int* drow = d_ring + slot * Wb;
      const int pos0 = delta + j0 - 1;
#pragma unroll
      for (int i = 0; i <= LPT; ++i) {
        const int pos = pos0 + i;
        const int s = pos + shift;
        if (pos >= 0 && s < Wb) {
          pm[i] = min(pm[i], mrow[s]);
          if (i > 0) pd[i - 1] = min(pd[i - 1], drow[s]);
        }
      }
    }
    if (t == 0) pm[0] = kInf;  // window lane 0 has no diagonal source

    const bool is_end = r == end_rank;
    const bool origin_rank =
        r == 0 || (EF && !DRIFT && p.free_start && !is_end);

    int A[LPT], Dv[LPT], tp[LPT];
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      const int j = jbase + i;
      const int Dc = min(min(pm[i + 1] + p.o + p.e, pd[i] + p.e), kInf);
      const int qi = p.mq + j;
      const int qs = (qi >= 0 && qi < p.LQ) ? __ldg(qrow + qi) : 0;
      const int diag = min(pm[i] + (qs == sym ? 0 : p.x), kInf);
      int a = min(diag, Dc);
      if (origin_rank && j == 0) a = min(a, 0);
      A[i] = a;
      Dv[i] = Dc;
      tp[i] = a - p.e * j;
    }
    // inclusive prefix-min: thread-local, then warp, then across warps
#pragma unroll
    for (int i = 1; i < LPT; ++i) tp[i] = min(tp[i], tp[i - 1]);
    int run = tp[LPT - 1];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, run, d);
      if (lane >= d) run = min(run, v);
    }
    const int before_in_warp = __shfl_up_sync(0xffffffffu, run, 1);
    if (lane == 31) warp_min[warp] = run;
    __syncthreads();
    int excl = lane > 0 ? before_in_warp : kScanIdentity;
    for (int w = 0; w < warp; ++w) excl = min(excl, warp_min[w]);

    const int wslot = __ldg(wslots + r);
    int* mdst = m_ring + wslot * Wb + j0;
    int* ddst = d_ring + wslot * Wb + j0;
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      const int j = jbase + i;
      int before = i == 0 ? excl : min(excl, tp[i - 1]);
      if (t == 0 && i == 0) before = kInf;  // XLA: INF enters at lane 0
      const int I = min(before + p.o + p.e * j, kInf);
      int M = min(A[i], I);
      int D = Dv[i];
      if (is_end) {
        M = pm[i + 1];
        D = kInf;
      }
      mdst[i] = M;
      ddst[i] = D;
      if (EF) {
        if (__ldg(end_ok + r) && j >= jlo_b && j <= len) best = min(best, M);
      } else if (is_end && j0 + i == len - w_r - sig) {
        out[b] = M;
      }
    }
    if (DRIFT && t == 0) slot_sig[wslot] = sig;
    __syncthreads();
  }

  if (EF) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      best = min(best, __shfl_xor_sync(0xffffffffu, best, d));
    if (lane == 0) warp_min[warp] = best;
    __syncthreads();
    if (t == 0) {
      int v = kInf;
      for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w)
        v = min(v, warp_min[w]);
      out[b] = v;
    }
  }
}

template <int LPT, bool DRIFT, bool EF>
cudaError_t launch(cudaStream_t stream, int B, size_t shmem,
                   const FillParams& p, const int* symbols,
                   const int* pred_slots, const int* pred_valid,
                   const int* pred_wstarts, const int* wstarts,
                   const int* wslots, const int* end_ok, const int* s_ranks,
                   const int* q, const int* lengths, const int* jlo,
                   int* out) {
  auto kernel = banded_fill_kernel<LPT, DRIFT, EF>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shmem));
  if (err != cudaSuccess) return err;
  kernel<<<B, p.Wb / LPT, shmem, stream>>>(p, symbols, pred_slots, pred_valid,
                                          pred_wstarts, wstarts, wslots,
                                          end_ok, s_ranks, q, lengths, jlo,
                                          out);
  return cudaGetLastError();
}

template <int LPT>
cudaError_t launch_mode(bool drift, bool ef, cudaStream_t stream, int B,
                        size_t shmem, const FillParams& p, const int* a0,
                        const int* a1, const int* a2, const int* a3,
                        const int* a4, const int* a5, const int* a6,
                        const int* a7, const int* a8, const int* a9,
                        const int* a10, int* out) {
  if (drift) {
    return ef ? launch<LPT, true, true>(stream, B, shmem, p, a0, a1, a2, a3,
                                        a4, a5, a6, a7, a8, a9, a10, out)
              : launch<LPT, true, false>(stream, B, shmem, p, a0, a1, a2, a3,
                                         a4, a5, a6, a7, a8, a9, a10, out);
  }
  return ef ? launch<LPT, false, true>(stream, B, shmem, p, a0, a1, a2, a3,
                                       a4, a5, a6, a7, a8, a9, a10, out)
            : launch<LPT, false, false>(stream, B, shmem, p, a0, a1, a2, a3,
                                        a4, a5, a6, a7, a8, a9, a10, out);
}

using I32 = ffi::Buffer<ffi::S32>;

ffi::Error BandedFillImpl(cudaStream_t stream, I32 symbols, I32 pred_slots,
                          I32 pred_valid, I32 pred_wstarts, I32 wstarts,
                          I32 wslots, I32 end_ok, I32 s_ranks, I32 q,
                          I32 lengths, I32 jlo,
                          ffi::ResultBuffer<ffi::S32> out, int32_t n_nodes,
                          int32_t P, int32_t W, int32_t Wb, int32_t o,
                          int32_t e, int32_t x, int32_t S, int32_t mq,
                          int32_t n_min, int32_t free_start, int32_t drift,
                          int32_t ef, int32_t lpt) {
  auto qdims = q.dimensions();
  if (qdims.size() != 2) return ffi::Error::InvalidArgument("q must be 2-D");
  const int B = static_cast<int>(qdims[0]);
  FillParams p{n_nodes, P, W, Wb, static_cast<int>(qdims[1]),
               o, e, x, S, mq, n_min, free_start};
  if (Wb % (32 * lpt) != 0 || Wb / lpt > 1024) {
    return ffi::Error::InvalidArgument("band width does not fit the block");
  }
  if (drift && S <= 0) return ffi::Error::InvalidArgument("drift needs S > 0");
  if (B == 0) return ffi::Error::Success();
  const size_t shmem = (2 * static_cast<size_t>(W) * Wb + 32 + W) * sizeof(int);
  const int* a[11] = {symbols.typed_data(),  pred_slots.typed_data(),
                      pred_valid.typed_data(), pred_wstarts.typed_data(),
                      wstarts.typed_data(),  wslots.typed_data(),
                      end_ok.typed_data(),   s_ranks.typed_data(),
                      q.typed_data(),        lengths.typed_data(),
                      jlo.typed_data()};
  int* o_ptr = out->typed_data();
  cudaError_t err;
  switch (lpt) {
    case 4:
      err = launch_mode<4>(drift, ef, stream, B, shmem, p, a[0], a[1], a[2],
                           a[3], a[4], a[5], a[6], a[7], a[8], a[9], a[10],
                           o_ptr);
      break;
    case 8:
      err = launch_mode<8>(drift, ef, stream, B, shmem, p, a[0], a[1], a[2],
                           a[3], a[4], a[5], a[6], a[7], a[8], a[9], a[10],
                           o_ptr);
      break;
    default:
      return ffi::Error::InvalidArgument("lanes per thread must be 4 or 8");
  }
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("banded fill launch: ") +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    BandedFill, BandedFillImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<I32>()  // symbols (Np,)
        .Arg<I32>()  // pred_slots (Np, P)
        .Arg<I32>()  // pred_valid (Np, P)
        .Arg<I32>()  // pred_wstarts (Np, P)
        .Arg<I32>()  // wstarts (Np,)
        .Arg<I32>()  // wslots (Np,)
        .Arg<I32>()  // end_ok (Np,)
        .Arg<I32>()  // s_ranks (Np,)
        .Arg<I32>()  // q (B, LQ)
        .Arg<I32>()  // lengths (B,)
        .Arg<I32>()  // jlo (B,)
        .Ret<I32>()  // scores (B,)
        .Attr<int32_t>("n_nodes")
        .Attr<int32_t>("P")
        .Attr<int32_t>("W")
        .Attr<int32_t>("Wb")
        .Attr<int32_t>("o")
        .Attr<int32_t>("e")
        .Attr<int32_t>("x")
        .Attr<int32_t>("S")
        .Attr<int32_t>("mq")
        .Attr<int32_t>("n_min")
        .Attr<int32_t>("free_start")
        .Attr<int32_t>("drift")
        .Attr<int32_t>("ef")
        .Attr<int32_t>("lpt"));
