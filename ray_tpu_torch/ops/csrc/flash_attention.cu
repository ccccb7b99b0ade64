// Flash attention for Hopper (sm_90a): forward, dq backward and dk/dv
// backward, on bf16 tensor cores with f32 accumulation, and the pre-pass
// that gives both backward kernels their delta = rowsum(dO * O).
//
// Replaces the Pallas TPU kernels of ray_tpu/ops/flash_attention.py:
//   fwd_kernel       <- _fwd_kernel      (launched by _flash_fwd)
//   bwd_dq_kernel    <- _bwd_dq_kernel   (launched by _flash_bwd)
//   bwd_dkv_kernel   <- _bwd_dkv_kernel  (launched by _flash_bwd)
//   bwd_delta_kernel <- the rowsum(dO * O) that _bwd_dq_kernel and
//                       _bwd_dkv_kernel take on every tile they visit
//
// What bounds them on an H100: at the training shapes (L=2048, D=64) each
// attention kernel does ~L/2 multiply-adds per byte it must move, far
// above the card's ~295 operations per byte, so they are bound by
// tensor-core throughput. Every kernel keeps the [L, L] scores out of
// device memory (one q tile, or one k tile, lives in registers while the
// other side streams through shared memory) and stops causal loops at the
// diagonal.
//
// The three attention kernels are built for Hopper's tensor-core path
// (hopper.cuh): one producer warp streams tiles by TMA into a ring of
// shared stages guarded by full/empty mbarriers, while two consumer
// warpgroups (64 rows each, registers moved to them by setmaxnreg) run
// wgmma on the swizzled tiles: products whose both operands are tiles
// (S = Q.K^T, dP = dO.V^T) read shared memory K-major, and products whose
// A is a probability or its gradient (O += P.V, dQ += dS.K, dV += P^T.dO,
// dK += dS^T.Q) take it from registers and read the other tile MN-major,
// so no tile is transposed or copied through registers. Masks are
// computed only on the diagonal tile and the tile that holds L's ragged
// end. Causal grids launch the heaviest tiles first, so the last wave is
// light. The TMA maps are encoded on the host at each launch through
// cuTensorMapEncodeTiled, reached by cudaGetDriverEntryPoint: the library
// links no libcuda.
//
// Layout: q/o/dq are [B, L, H, D] and k/v/dk/dv are [B, L, KVH, D], read
// through their batch/sequence/head strides (the head dim is contiguous).
// Query head h reads kv head h / (H / KVH); repeated kv is never built, and
// dk/dv sum over a kv head's group in registers (no atomics). lse and delta
// are [B, H, L] f32. Ragged sequence tails are masked, never dropped; TMA
// reads rows past L as zeros.
//
// Numerics follow the TPU kernels: f32 scores with the scale applied to
// the f32 product, NEG_INF = -1e30 masking, f32 softmax statistics and
// accumulators, p rounded to bf16 before p.V and p^T.dO, ds rounded to
// bf16 before ds.K and ds^T.Q, delta = rowsum(dO * O) in f32, l clamped
// at 1e-30, lse = m + ln(l), dk and dq scaled at the end. exp(x) is taken
// as exp2 with scale * log2(e) folded into one multiply-add. Every sum
// runs in a fixed order: two launches give identical bits.
//
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;
using hopper::pack_bf16;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_DEVICES = 64;

struct View {  // a [B, L, heads, D] bf16 tensor with a contiguous head dim
  const bf16* p;
  long long sb, sl, sh;
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ------------------------------------------------- warp-specialised blocks
// Threads 0-127 are the producer warpgroup (its warp 0 issues the loads,
// the rest idle on few registers); 128-255 and 256-383 are the two consumer
// warpgroups, each owning 64 rows of the block's tile.

constexpr int WG = 128;
constexpr int WS_THREADS = 3 * WG;
constexpr int PRODUCER_REGS = 40;   // 128 x 40 + 256 x 232 <= 65,536
constexpr int CONSUMER_REGS = 232;
constexpr int CONSUMER_WARPS = 8;   // arrivals that free a stage

// The dynamic shared memory, rounded up to the swizzle's 1024 bytes.
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  const uint32_t a = hopper::smem_u32(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

// One barrier for the block's resident tile, then full/empty per stage.
template <int STAGES>
__device__ __forceinline__ void init_barriers(uint64_t* bars) {
  if (threadIdx.x == 0) {
    hopper::mbar_init(&bars[0], 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&bars[1 + s], 1);
      hopper::mbar_init(&bars[1 + STAGES + s], CONSUMER_WARPS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
}

// A consumer warp is done with a stage once its products have completed.
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) hopper::mbar_arrive(empty);
}

struct FwdArgs {
  bf16* o;     // [B, L, H, D], contiguous
  float* lse;  // [B, H, L]
  int L, H, KVH, causal, q_tiles;
  float scale, scale_log2;
};

template <int D>
struct FwdShape {
  static constexpr int BM = 128, BN = 128, STAGES = 2;
  using QT = hopper::Tile<BM, D>;
  using KT = hopper::Tile<BN, D>;
  static constexpr int Q = 0, K = QT::BYTES, V = K + STAGES * KT::BYTES,
                       BARS = V + STAGES * KT::BYTES;
  static constexpr int SMEM = BARS + 8 * (1 + 2 * STAGES) + 1024;
};

// ------------------------------------------------------------------ forward
// One block: 128 query rows of one (batch, head). Q stays resident; K and
// V tiles of 128 keys stream through the ring. Each consumer warpgroup
// keeps its 64 rows' output, running max and (per-thread partial) row sums
// in registers.
template <int D>
__global__ void __launch_bounds__(WS_THREADS, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, const FwdArgs a) {
  using S = FwdShape<D>;
  using QT = typename S::QT;
  using KT = typename S::KT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t base = hopper::smem_u32(smem);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + S::STAGES;

  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int kvh = h / (a.H / a.KVH);
  // Under a causal mask the heaviest q tiles (the last) launch first.
  const int qt = a.causal ? a.q_tiles - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int q0 = qt * S::BM;
  const int kend = a.causal ? min(a.L, q0 + S::BM) : a.L;
  const int k_tiles = (kend + S::BN - 1) / S::BN;
  init_barriers<S::STAGES>(bar_q);

  if (threadIdx.x < WG) {
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(bar_q, QT::BYTES);
      hopper::tma_load_tile<QT>(base + S::Q, &tm_q, bar_q, h, q0, b);
      for (int j = 0; j < k_tiles; ++j) {
        const int s = j % S::STAGES;
        hopper::mbar_wait(&empty[s], ((j / S::STAGES) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], 2 * KT::BYTES);
        hopper::tma_load_tile<KT>(base + S::K + s * KT::BYTES, &tm_k,
                                  &full[s], kvh, j * S::BN, b);
        hopper::tma_load_tile<KT>(base + S::V + s * KT::BYTES, &tm_v,
                                  &full[s], kvh, j * S::BN, b);
      }
    }
  } else {
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    const int tid = threadIdx.x - WG;
    const int wg = tid / WG, warp = (tid % WG) / 32, lane = tid % 32;
    const int col0 = 2 * (lane % 4);
    const int row[2] = {q0 + 64 * wg + 16 * warp + lane / 4,
                        q0 + 64 * wg + 16 * warp + lane / 4 + 8};
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    hopper::mbar_wait(bar_q, 0);

    for (int j = 0; j < k_tiles; ++j) {
      const int s = j % S::STAGES;
      const uint32_t qb = hopper::opaque(base) + S::Q;
      const uint32_t kb = base + S::K + s * KT::BYTES;
      const uint32_t vb = base + S::V + s * KT::BYTES;
      hopper::mbar_wait(&full[s], (j / S::STAGES) & 1);

      float sc[S::BN / 2];  // raw scores q.k of the thread's two rows
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<S::BN>(sc, hopper::desc_k<QT>(qb, 64 * wg, kk),
                                hopper::desc_k<KT>(kb, 0, kk), kk);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(sc);

      // Only the diagonal tile and the tile holding L's end need masks.
      if ((a.causal && j == k_tiles - 1) || (j + 1) * S::BN > a.L) {
#pragma unroll
        for (int n = 0; n < S::BN / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = j * S::BN + 8 * n + col0 + (e & 1);
            if (col >= a.L || (a.causal && col > row[e >> 1]))
              sc[4 * n + e] = NEG_INF;
          }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < S::BN / 2; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float alpha[2], mc[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = quad_max(mx[i]);
        alpha[i] = exp2f((m[i] - mx[i]) * a.scale_log2);
        mc[i] = mx[i] * a.scale_log2;
        m[i] = mx[i];
      }
#pragma unroll
      for (int i = 0; i < S::BN / 2; ++i) {
        sc[i] = exp2f(fmaf(sc[i], a.scale_log2, -mc[(i >> 1) & 1]));
        rs[(i >> 1) & 1] += sc[i];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = alpha[i] * l[i] + rs[i];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

      // p, rounded to bf16, is the A fragment of O += P.V.
      uint32_t pf[S::BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < S::BN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pf[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < S::BN / 16; ++kk)
        hopper::wgmma_rs<D>(acc, pf[kk], hopper::desc_mn<KT>(vb, kk), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(acc);
      release(&empty[s], lane);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float l_safe = fmaxf(quad_sum(l[i]), 1e-30f), inv = 1.f / l_safe;
      if (row[i] >= a.L) continue;
      bf16* o = a.o + (((long long)b * a.L + row[i]) * a.H + h) * D + col0;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(o + 8 * n) =
            pack_bf16(acc[4 * n + 2 * i] * inv, acc[4 * n + 2 * i + 1] * inv);
      if (lane % 4 == 0)
        a.lse[((long long)b * a.H + h) * a.L + row[i]] =
            m[i] * a.scale + logf(l_safe);
    }
  }
}

// --------------------------------------------------------- backward delta
// delta[b, h, l] = sum_d dO[b, l, h, d] * O[b, l, h, d] in f32, once, for
// bwd_dq_kernel and bwd_dkv_kernel to read as they read lse. D/8 adjacent
// lanes own a row, one 16-byte vector each, and sum it by shuffles.
template <int D>
__global__ void __launch_bounds__(256)
    bwd_delta_kernel(const View o, const View dout, float* delta, int L,
                     int H, long long rows) {
  constexpr int CPR = D / 8;
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  const long long r = i / CPR;
  const int c = (int)(i % CPR) * 8;
  float part = 0.f;
  if (r < rows) {
    // Rows in delta's [B, H, L] order: adjacent rows write adjacent words.
    const int l = (int)(r % L), h = (int)((r / L) % H);
    const int b = (int)(r / ((long long)L * H));
    const uint4 vo = *reinterpret_cast<const uint4*>(
        o.p + b * o.sb + l * o.sl + h * o.sh + c);
    const uint4 vd = *reinterpret_cast<const uint4*>(
        dout.p + b * dout.sb + l * dout.sl + h * dout.sh + c);
    const bf16* eo = reinterpret_cast<const bf16*>(&vo);
    const bf16* ed = reinterpret_cast<const bf16*>(&vd);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      part += __bfloat162float(ed[j]) * __bfloat162float(eo[j]);
  }
#pragma unroll
  for (int off = CPR / 2; off > 0; off >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, off);
  if (r < rows && c == 0) delta[r] = part;
}

struct DkvArgs {
  bf16* dk;            // [B, L, KVH, D], contiguous
  bf16* dv;            // [B, L, KVH, D], contiguous
  const float* lse;    // [B, H, L]
  const float* delta;  // [B, H, L]
  int L, H, KVH, causal;
  float scale, scale_log2;
};

template <int D>
struct DkvShape {
  static constexpr int BM = 128, BQ = 64, STAGES = 2;
  using KT = hopper::Tile<BM, D>;
  using QT = hopper::Tile<BQ, D>;
  static constexpr int K = 0, V = KT::BYTES, Q = 2 * KT::BYTES,
                       DO = Q + STAGES * QT::BYTES,
                       LSE = DO + STAGES * QT::BYTES,
                       DELTA = LSE + STAGES * BQ * 4,
                       BARS = DELTA + STAGES * BQ * 4;
  static constexpr int SMEM = BARS + 8 * (1 + 2 * STAGES) + 1024;
};

// ------------------------------------------------------------ backward dkv
// One block: 128 keys of one (batch, kv head); K and V stay resident. The
// producer streams, for each query head of the group and each q tile from
// the diagonal on, the Q and dO tiles (64 rows) with their lse (times
// log2(e)) and delta. Each consumer warpgroup owns 64 keys and computes
// s^T = K.Q^T and dp^T = V.dO^T, then dV += p^T.dO and dK += ds^T.Q with
// p^T and ds^T from registers and dO, Q read MN-major from the same tiles.
template <int D>
__global__ void __launch_bounds__(WS_THREADS, 1)
    bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do,
                   const DkvArgs a) {
  using S = DkvShape<D>;
  using QT = typename S::QT;
  using KT = typename S::KT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t base = hopper::smem_u32(smem);
  float* s_lse = reinterpret_cast<float*>(smem + S::LSE);
  float* s_delta = reinterpret_cast<float*>(smem + S::DELTA);
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + S::STAGES;

  const int b = blockIdx.x / a.KVH, kvh = blockIdx.x % a.KVH;
  const int reps = a.H / a.KVH;
  // Key tile 0, the heaviest under a causal mask, launches first.
  const int k0 = blockIdx.y * S::BM;
  // q tiles before this key tile never attend to it.
  const int qstart = a.causal ? k0 : 0;
  const int q_tiles = (a.L - qstart + S::BQ - 1) / S::BQ;
  const int steps = reps * q_tiles;
  init_barriers<S::STAGES>(bar_kv);

  if (threadIdx.x < WG) {
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        hopper::mbar_expect_tx(bar_kv, 2 * KT::BYTES);
        hopper::tma_load_tile<KT>(base + S::K, &tm_k, bar_kv, kvh, k0, b);
        hopper::tma_load_tile<KT>(base + S::V, &tm_v, bar_kv, kvh, k0, b);
      }
      for (int it = 0; it < steps; ++it) {
        const int s = it % S::STAGES;
        const int h = kvh * reps + it / q_tiles;
        const int qs = qstart + (it % q_tiles) * S::BQ;
        const long long row = ((long long)b * a.H + h) * a.L;
        hopper::mbar_wait(&empty[s], ((it / S::STAGES) & 1) ^ 1);
        for (int i = lane; i < S::BQ; i += 32) {
          const bool ok = qs + i < a.L;
          s_lse[s * S::BQ + i] = ok ? a.lse[row + qs + i] * LOG2E : 0.f;
          s_delta[s * S::BQ + i] = ok ? a.delta[row + qs + i] : 0.f;
        }
        __syncwarp();
        if (lane == 0) {
          hopper::mbar_expect_tx(&full[s], 2 * QT::BYTES);
          hopper::tma_load_tile<QT>(base + S::Q + s * QT::BYTES, &tm_q,
                                    &full[s], h, qs, b);
          hopper::tma_load_tile<QT>(base + S::DO + s * QT::BYTES, &tm_do,
                                    &full[s], h, qs, b);
        }
      }
    }
  } else {
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    const int tid = threadIdx.x - WG;
    const int wg = tid / WG, warp = (tid % WG) / 32, lane = tid % 32;
    const int col0 = 2 * (lane % 4);
    const int kw = k0 + 64 * wg;  // this warpgroup's first key
    const int key[2] = {kw + 16 * warp + lane / 4,
                        kw + 16 * warp + lane / 4 + 8};
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    hopper::mbar_wait(bar_kv, 0);

    for (int it = 0; it < steps; ++it) {
      const int s = it % S::STAGES;
      const int qs = qstart + (it % q_tiles) * S::BQ;
      hopper::mbar_wait(&full[s], (it / S::STAGES) & 1);
      // A q tile wholly before this warpgroup's keys adds nothing.
      if (!(a.causal && qs + S::BQ <= kw)) {
        const uint32_t kb = hopper::opaque(base);
        const uint32_t qb = base + S::Q + s * QT::BYTES;
        const uint32_t dob = base + S::DO + s * QT::BYTES;
        const float* lse2 = s_lse + s * S::BQ;
        const float* dl = s_delta + s * S::BQ;
        float st[S::BQ / 2], dpt[S::BQ / 2];
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::wgmma_ss<S::BQ>(
              st, hopper::desc_k<KT>(kb + S::K, 64 * wg, kk),
              hopper::desc_k<QT>(qb, 0, kk), kk);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::wgmma_ss<S::BQ>(
              dpt, hopper::desc_k<KT>(kb + S::V, 64 * wg, kk),
              hopper::desc_k<QT>(dob, 0, kk), kk);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_operands(st);
        hopper::fence_operands(dpt);

        // Only the diagonal tiles and the tile holding L's end need masks.
        // p^T and ds^T are packed to bf16 as they are made, so each pair of
        // f32 values dies at once.
        const bool edge = (a.causal && qs < kw + 64) || qs + S::BQ > a.L;
        uint32_t pa[S::BQ / 16][4], da[S::BQ / 16][4];
#pragma unroll
        for (int kk = 0; kk < S::BQ / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            float p[2], ds[2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int i = 8 * kk + 2 * r + c;
              const int qi = 8 * (i >> 2) + col0 + (i & 1);
              float x = st[i];
              if (edge && (qs + qi >= a.L ||
                           (a.causal && qs + qi < key[(i >> 1) & 1])))
                x = NEG_INF;
              p[c] = exp2f(fmaf(x, a.scale_log2, -lse2[qi]));
              ds[c] = p[c] * (dpt[i] - dl[qi]);
            }
            pa[kk][r] = pack_bf16(p[0], p[1]);
            da[kk][r] = pack_bf16(ds[0], ds[1]);
          }
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < S::BQ / 16; ++kk) {
          hopper::wgmma_rs<D>(dv, pa[kk], hopper::desc_mn<QT>(dob, kk), 1);
          hopper::wgmma_rs<D>(dk, da[kk], hopper::desc_mn<QT>(qb, kk), 1);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_operands(dv);
        hopper::fence_operands(dk);
      }
      release(&empty[s], lane);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (key[i] >= a.L) continue;
      const long long off =
          (((long long)b * a.L + key[i]) * a.KVH + kvh) * D + col0;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<uint32_t*>(a.dk + off + 8 * n) = pack_bf16(
            dk[4 * n + 2 * i] * a.scale, dk[4 * n + 2 * i + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(a.dv + off + 8 * n) =
            pack_bf16(dv[4 * n + 2 * i], dv[4 * n + 2 * i + 1]);
      }
    }
  }
}

struct DqArgs {
  bf16* dq;            // [B, L, H, D], contiguous
  const float* lse;    // [B, H, L]
  const float* delta;  // [B, H, L]
  int L, H, KVH, causal, q_tiles;
  float scale, scale_log2;
};

// 128 q rows by 64 keys. With 128-key tiles, S, dP and the dS fragments
// beside dQ's accumulators spilled at D = 32 and 64 (and would at 128), and
// the kernel timed slower on the H100 at every D; a third stage and
// waiting for S apart from dP timed slower too.
template <int D>
struct DqShape {
  static constexpr int BM = 128, BN = 64, STAGES = 2;
  using QT = hopper::Tile<BM, D>;
  using KT = hopper::Tile<BN, D>;
  static constexpr int Q = 0, DO = QT::BYTES, K = 2 * QT::BYTES,
                       V = K + STAGES * KT::BYTES,
                       BARS = V + STAGES * KT::BYTES;
  static constexpr int SMEM = BARS + 8 * (1 + 2 * STAGES) + 1024;
};

// ------------------------------------------------------------- backward dq
// Replaces _bwd_dq_kernel. Bound by operations: three products per
// (row, key) pair (S, dP, dQ), 0.104 ms of tensor-core time at the slice
// shape (B=8, L=2048, H=16, KVH=8, D=64, causal). So the design keeps the
// tensor cores fed and everything else off their path: one block holds
// 128 query rows of one (batch, head); Q and dO stay resident, and each
// row's lse (times log2(e)) and delta (from the pre-pass) sit in
// registers. K and V tiles of the query head's kv head stream through the
// ring. Each consumer warpgroup owns 64 rows: S = Q.K^T and dP = dO.V^T
// from shared memory in one commit, dS = P * (dP - delta) packed to bf16 A
// fragments as it is made, then dQ += dS.K with K read MN-major from the
// tile that S read K-major. dQ stays in registers and is scaled and
// rounded once.
template <int D>
__global__ void __launch_bounds__(WS_THREADS, 1)
    bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_do,
                  const DqArgs a) {
  using S = DqShape<D>;
  using QT = typename S::QT;
  using KT = typename S::KT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t base = hopper::smem_u32(smem);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + S::STAGES;

  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int kvh = h / (a.H / a.KVH);
  // Under a causal mask the heaviest q tiles (the last) launch first.
  const int qt = a.causal ? a.q_tiles - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int q0 = qt * S::BM;
  const int kend = a.causal ? min(a.L, q0 + S::BM) : a.L;
  const int k_tiles = (kend + S::BN - 1) / S::BN;
  init_barriers<S::STAGES>(bar_q);

  if (threadIdx.x < WG) {
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(bar_q, 2 * QT::BYTES);
      hopper::tma_load_tile<QT>(base + S::Q, &tm_q, bar_q, h, q0, b);
      hopper::tma_load_tile<QT>(base + S::DO, &tm_do, bar_q, h, q0, b);
      for (int j = 0; j < k_tiles; ++j) {
        const int s = j % S::STAGES;
        hopper::mbar_wait(&empty[s], ((j / S::STAGES) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], 2 * KT::BYTES);
        hopper::tma_load_tile<KT>(base + S::K + s * KT::BYTES, &tm_k,
                                  &full[s], kvh, j * S::BN, b);
        hopper::tma_load_tile<KT>(base + S::V + s * KT::BYTES, &tm_v,
                                  &full[s], kvh, j * S::BN, b);
      }
    }
  } else {
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    const int tid = threadIdx.x - WG;
    const int wg = tid / WG, warp = (tid % WG) / 32, lane = tid % 32;
    const int col0 = 2 * (lane % 4);
    const int rw = q0 + 64 * wg;  // this warpgroup's first row
    const int row[2] = {rw + 16 * warp + lane / 4,
                        rw + 16 * warp + lane / 4 + 8};
    float lse2[2], dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool ok = row[i] < a.L;
      const long long r = ((long long)b * a.H + h) * a.L + row[i];
      lse2[i] = ok ? a.lse[r] * LOG2E : 0.f;
      dl[i] = ok ? a.delta[r] : 0.f;
    }
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    hopper::mbar_wait(bar_q, 0);

    for (int j = 0; j < k_tiles; ++j) {
      const int s = j % S::STAGES;
      const int k0 = j * S::BN;
      hopper::mbar_wait(&full[s], (j / S::STAGES) & 1);
      // A key tile wholly after this warpgroup's rows adds nothing.
      if (!(a.causal && k0 > rw + 63)) {
        const uint32_t sb = hopper::opaque(base);
        const uint32_t qb = sb + S::Q, dob = sb + S::DO;
        const uint32_t kb = sb + S::K + s * KT::BYTES;
        const uint32_t vb = sb + S::V + s * KT::BYTES;
        float sc[S::BN / 2], dp[S::BN / 2];
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::wgmma_ss<S::BN>(sc, hopper::desc_k<QT>(qb, 64 * wg, kk),
                                  hopper::desc_k<KT>(kb, 0, kk), kk);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::wgmma_ss<S::BN>(dp, hopper::desc_k<QT>(dob, 64 * wg, kk),
                                  hopper::desc_k<KT>(vb, 0, kk), kk);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_operands(sc);
        hopper::fence_operands(dp);

        // Only the diagonal tile and the tile holding L's end need masks.
        // ds is packed to bf16 as it is made, so each pair of f32 values
        // dies at once.
        const bool edge = (a.causal && k0 + S::BN - 1 > rw) || k0 + S::BN > a.L;
        uint32_t da[S::BN / 16][4];
#pragma unroll
        for (int kk = 0; kk < S::BN / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            float ds[2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int i = 8 * kk + 2 * r + c, ri = (i >> 1) & 1;
              const int col = k0 + 8 * (i >> 2) + col0 + (i & 1);
              float x = sc[i];
              if (edge && (col >= a.L || (a.causal && col > row[ri])))
                x = NEG_INF;
              const float p = exp2f(fmaf(x, a.scale_log2, -lse2[ri]));
              ds[c] = p * (dp[i] - dl[ri]);
            }
            da[kk][r] = pack_bf16(ds[0], ds[1]);
          }
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < S::BN / 16; ++kk)
          hopper::wgmma_rs<D>(acc, da[kk], hopper::desc_mn<KT>(kb, kk), 1);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_operands(acc);
      }
      release(&empty[s], lane);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (row[i] >= a.L) continue;
      bf16* dq = a.dq + (((long long)b * a.L + row[i]) * a.H + h) * D + col0;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(dq + 8 * n) = pack_bf16(
            acc[4 * n + 2 * i] * a.scale, acc[4 * n + 2 * i + 1] * a.scale);
    }
  }
}

// ------------------------------------------------------------------ launch

enum Kind { FWD = 0, BWD_DQ = 1, BWD_DKV = 2, BWD_DELTA = 3 };

template <int D>
size_t smem_bytes(int kind) {
  switch (kind) {
    case FWD: return FwdShape<D>::SMEM;
    case BWD_DQ: return DqShape<D>::SMEM;
    case BWD_DKV: return DkvShape<D>::SMEM;
    default: return 0;
  }
}

// The shared-memory limit is an attribute of the kernel on each device:
// set it at a kernel's first launch on a device, not at every launch.
cudaError_t allow_smem(const void* kernel, size_t smem, bool* configured) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!configured[device]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured[device] = true;
  }
  return cudaSuccess;
}

template <int D>
cudaError_t launch_fwd(const CUtensorMap& q, const CUtensorMap& k,
                       const CUtensorMap& v, const FwdArgs& a, int B,
                       cudaStream_t stream) {
  static bool configured[MAX_DEVICES] = {};
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(fwd_kernel<D>),
                               FwdShape<D>::SMEM, configured);
  if (err != cudaSuccess) return err;
  fwd_kernel<D><<<dim3(B * a.H, a.q_tiles), WS_THREADS, FwdShape<D>::SMEM,
                  stream>>>(q, k, v, a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const CUtensorMap& q, const CUtensorMap& k,
                       const CUtensorMap& v, const CUtensorMap& dout,
                       const DkvArgs& a, int B, cudaStream_t stream) {
  static bool configured[MAX_DEVICES] = {};
  cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(bwd_dkv_kernel<D>), DkvShape<D>::SMEM,
      configured);
  if (err != cudaSuccess) return err;
  const int k_tiles = (a.L + DkvShape<D>::BM - 1) / DkvShape<D>::BM;
  bwd_dkv_kernel<D><<<dim3(B * a.KVH, k_tiles), WS_THREADS,
                      DkvShape<D>::SMEM, stream>>>(q, k, v, dout, a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const CUtensorMap& q, const CUtensorMap& k,
                      const CUtensorMap& v, const CUtensorMap& dout,
                      const DqArgs& a, int B, cudaStream_t stream) {
  static bool configured[MAX_DEVICES] = {};
  cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(bwd_dq_kernel<D>), DqShape<D>::SMEM,
      configured);
  if (err != cudaSuccess) return err;
  bwd_dq_kernel<D><<<dim3(B * a.H, a.q_tiles), WS_THREADS, DqShape<D>::SMEM,
                     stream>>>(q, k, v, dout, a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_delta(const View& o, const View& dout, float* delta,
                         int B, int L, int H, cudaStream_t stream) {
  const long long rows = (long long)B * L * H;
  const long long threads = rows * (D / 8);
  bwd_delta_kernel<D><<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
      o, dout, delta, L, H, rows);
  return cudaGetLastError();
}

View view(const void* ptr, long long sb, long long sl, long long sh) {
  return View{static_cast<const bf16*>(ptr), sb, sl, sh};
}

bool supported(int d) { return d == 16 || d == 32 || d == 64 || d == 128; }

}  // namespace

extern "C" {

const char* rtt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory of one block of `kind` (0 fwd, 1 dq, 2 dkv,
// 3 delta), or 0 for an unsupported head dim.
long long rtt_flash_smem_bytes(int kind, int d) {
  switch (d) {
    case 16: return (long long)smem_bytes<16>(kind);
    case 32: return (long long)smem_bytes<32>(kind);
    case 64: return (long long)smem_bytes<64>(kind);
    case 128: return (long long)smem_bytes<128>(kind);
    default: return 0;
  }
}

int rtt_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, int B, int L, int H, int KVH, int D, int causal,
                  float scale, long long q_sb, long long q_sl, long long q_sh,
                  long long k_sb, long long k_sl, long long k_sh,
                  long long v_sb, long long v_sl, long long v_sh,
                  void* stream) {
  if (!supported(D)) return (int)cudaErrorInvalidValue;
  const int rows = FwdShape<64>::BM;  // q and kv tiles: 128 rows at every D
  CUtensorMap tq, tk, tv;
  cudaError_t err =
      hopper::encode_rows(&tq, q, D, H, L, B, q_sh, q_sl, q_sb, rows);
  if (err == cudaSuccess)
    err = hopper::encode_rows(&tk, k, D, KVH, L, B, k_sh, k_sl, k_sb, rows);
  if (err == cudaSuccess)
    err = hopper::encode_rows(&tv, v, D, KVH, L, B, v_sh, v_sl, v_sb, rows);
  if (err != cudaSuccess) return (int)err;
  FwdArgs a = {};
  a.o = static_cast<bf16*>(o);
  a.lse = static_cast<float*>(lse);
  a.L = L; a.H = H; a.KVH = KVH; a.causal = causal;
  a.q_tiles = (L + rows - 1) / rows;
  a.scale = scale; a.scale_log2 = scale * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return (int)launch_fwd<16>(tq, tk, tv, a, B, s);
    case 32: return (int)launch_fwd<32>(tq, tk, tv, a, B, s);
    case 64: return (int)launch_fwd<64>(tq, tk, tv, a, B, s);
    default: return (int)launch_fwd<128>(tq, tk, tv, a, B, s);
  }
}

int rtt_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int B, int L, int H, int KVH, int D,
                     int causal, float scale,
                     long long q_sb, long long q_sl, long long q_sh,
                     long long k_sb, long long k_sl, long long k_sh,
                     long long v_sb, long long v_sl, long long v_sh,
                     long long do_sb, long long do_sl, long long do_sh,
                     void* stream) {
  if (!supported(D)) return (int)cudaErrorInvalidValue;
  // q/dO tiles of 128 rows and k/v tiles of 64 keys at every D
  const int qrows = DqShape<64>::BM, krows = DqShape<64>::BN;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err =
      hopper::encode_rows(&tq, q, D, H, L, B, q_sh, q_sl, q_sb, qrows);
  if (err == cudaSuccess)
    err = hopper::encode_rows(&tk, k, D, KVH, L, B, k_sh, k_sl, k_sb, krows);
  if (err == cudaSuccess)
    err = hopper::encode_rows(&tv, v, D, KVH, L, B, v_sh, v_sl, v_sb, krows);
  if (err == cudaSuccess)
    err = hopper::encode_rows(&tdo, dout, D, H, L, B, do_sh, do_sl, do_sb,
                              qrows);
  if (err != cudaSuccess) return (int)err;
  DqArgs a = {};
  a.dq = static_cast<bf16*>(dq);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.L = L; a.H = H; a.KVH = KVH; a.causal = causal;
  a.q_tiles = (L + qrows - 1) / qrows;
  a.scale = scale; a.scale_log2 = scale * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return (int)launch_dq<16>(tq, tk, tv, tdo, a, B, s);
    case 32: return (int)launch_dq<32>(tq, tk, tv, tdo, a, B, s);
    case 64: return (int)launch_dq<64>(tq, tk, tv, tdo, a, B, s);
    default: return (int)launch_dq<128>(tq, tk, tv, tdo, a, B, s);
  }
}

int rtt_flash_bwd_delta(const void* o, const void* dout, void* delta, int B,
                        int L, int H, int D, long long o_sb, long long o_sl,
                        long long o_sh, long long do_sb, long long do_sl,
                        long long do_sh, void* stream) {
  const View vo = view(o, o_sb, o_sl, o_sh);
  const View vd = view(dout, do_sb, do_sl, do_sh);
  float* out = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return (int)launch_delta<16>(vo, vd, out, B, L, H, s);
    case 32: return (int)launch_delta<32>(vo, vd, out, B, L, H, s);
    case 64: return (int)launch_delta<64>(vo, vd, out, B, L, H, s);
    case 128: return (int)launch_delta<128>(vo, vd, out, B, L, H, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int rtt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int B, int L, int H, int KVH,
                      int D, int causal, float scale,
                      long long q_sb, long long q_sl, long long q_sh,
                      long long k_sb, long long k_sl, long long k_sh,
                      long long v_sb, long long v_sl, long long v_sh,
                      long long do_sb, long long do_sl, long long do_sh,
                      void* stream) {
  if (!supported(D)) return (int)cudaErrorInvalidValue;
  // k/v tiles of 128 rows and q/dO tiles of 64 at every D
  const int krows = DkvShape<64>::BM, qrows = DkvShape<64>::BQ;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err =
      hopper::encode_rows(&tq, q, D, H, L, B, q_sh, q_sl, q_sb, qrows);
  if (err == cudaSuccess)
    err = hopper::encode_rows(&tk, k, D, KVH, L, B, k_sh, k_sl, k_sb, krows);
  if (err == cudaSuccess)
    err = hopper::encode_rows(&tv, v, D, KVH, L, B, v_sh, v_sl, v_sb, krows);
  if (err == cudaSuccess)
    err = hopper::encode_rows(&tdo, dout, D, H, L, B, do_sh, do_sl, do_sb,
                              qrows);
  if (err != cudaSuccess) return (int)err;
  DkvArgs a = {};
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.L = L; a.H = H; a.KVH = KVH; a.causal = causal;
  a.scale = scale; a.scale_log2 = scale * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return (int)launch_dkv<16>(tq, tk, tv, tdo, a, B, s);
    case 32: return (int)launch_dkv<32>(tq, tk, tv, tdo, a, B, s);
    case 64: return (int)launch_dkv<64>(tq, tk, tv, tdo, a, B, s);
    default: return (int)launch_dkv<128>(tq, tk, tv, tdo, a, B, s);
  }
}

}  // extern "C"
