// Flash attention for Hopper (sm_90a): forward, dq backward and dk/dv
// backward, each one CUDA kernel on bf16 tensor cores (mma.sync m16n8k16,
// f32 accumulation).
//
// Replaces the Pallas TPU kernels of ray_tpu/ops/flash_attention.py:
//   fwd_kernel     <- _fwd_kernel      (launched by _flash_fwd)
//   bwd_dq_kernel  <- _bwd_dq_kernel   (launched by _flash_bwd)
//   bwd_dkv_kernel <- _bwd_dkv_kernel  (launched by _flash_bwd)
//
// What bounds them on an H100: at the training shapes (L=2048, D=64) each
// kernel does ~L/2 multiply-adds per byte it must move, far above the
// card's ~295 operations per byte, so all three are bound by tensor-core
// throughput. The design keeps the [L, L] scores out of device memory (one
// q tile, or one k tile, lives in registers while the other side streams
// through shared memory), stops causal loops at the diagonal, and feeds
// the tensor cores from padded, bank-conflict-free shared tiles. It is the
// simple version: mma.sync without wgmma, TMA or a load pipeline, so it
// reaches a fraction of the tensor-core peak.
//
// Layout: q/o/dq are [B, L, H, D] and k/v/dk/dv are [B, L, KVH, D], read
// through their batch/sequence/head strides (the head dim is contiguous).
// Query head h reads kv head h / (H / KVH); repeated kv is never built.
// lse is [B, H, L] f32. Tiles are fixed (64 rows); ragged sequence tails
// are masked, never dropped.
//
// Numerics follow the TPU kernels: f32 scores with the scale applied to
// the f32 product, NEG_INF = -1e30 masking, f32 softmax statistics and
// accumulators, p rounded to bf16 before p.V and p^T.dO, ds rounded to
// bf16 before ds.K and ds^T.Q, D = rowsum(dO * O) in f32, l clamped at
// 1e-30.
//
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float NEG_INF = -1e30f;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BM = WARPS * 16;  // rows a block owns: q rows (fwd, dq), keys (dkv)
constexpr int BN = 64;          // rows of the streamed tile: keys (fwd, dq), q rows (dkv)
constexpr int LDN = BN + 8;     // padded row of a transposed tile (conflict-free)

struct View {  // a [B, L, heads, D] bf16 tensor with a contiguous head dim
  const bf16* p;
  long long sb, sl, sh;
};

struct Params {
  View q, k, v, o, dout;
  const float* lse_in;  // [B, H, L]
  bf16* o_out;          // [B, L, H, D], contiguous
  float* lse_out;       // [B, H, L]
  bf16* dq;             // [B, L, H, D], contiguous
  bf16* dk;             // [B, L, KVH, D], contiguous
  bf16* dv;             // [B, L, KVH, D], contiguous
  int B, L, H, KVH, causal;
  float scale;
};

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment (16x16, row-major) of the shared tile s at rows r0.., cols k0..
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* s, int ld,
                                       int r0, int k0, int lane) {
  const bf16* p = s + (r0 + (lane >> 2)) * ld + k0 + (lane & 3) * 2;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 8);
}

// B fragment (16x8, B[k][n] = s[n0 + n][k0 + k]) of the shared tile s.
__device__ __forceinline__ void load_b(uint32_t b[2], const bf16* s, int ld,
                                       int n0, int k0, int lane) {
  const bf16* p = s + (n0 + (lane >> 2)) * ld + k0 + (lane & 3) * 2;
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}

// The C fragments of two adjacent 16x8 products, rounded to bf16, form the
// A fragment of the next product (k = the 16 columns of the pair).
__device__ __forceinline__ void c_to_a(uint32_t a[4], const float c0[4],
                                       const float c1[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Copy rows [row0, row0 + R) of one head of a view into a shared tile,
// row-major with row stride ld and/or transposed ([D][LDN]). Rows at or
// past `valid` are zero.
template <int D, int R>
__device__ __forceinline__ void load_tile(bf16* s, int ld, bf16* st,
                                          const bf16* g, long long sl,
                                          int row0, int valid) {
  constexpr int CPR = D / 8;
  for (int i = threadIdx.x; i < R * CPR; i += THREADS) {
    const int r = i / CPR, c = (i % CPR) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid)
      v = *reinterpret_cast<const uint4*>(g + (long long)(row0 + r) * sl + c);
    if (s) *reinterpret_cast<uint4*>(s + r * ld + c) = v;
    if (st) {
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) st[(c + j) * LDN + r] = e[j];
    }
  }
}

// out[r] = sum_d a[row0 + r, d] * b[row0 + r, d] in f32 (0 past `valid`).
// The D/8 chunks of a row sit on adjacent lanes and are summed by shuffles.
template <int D, int R>
__device__ __forceinline__ void row_dot(float* out, const bf16* a,
                                        long long a_sl, const bf16* b,
                                        long long b_sl, int row0, int valid) {
  constexpr int CPR = D / 8;
  static_assert((R * CPR) % THREADS == 0 && 32 % CPR == 0, "row_dot tiling");
  for (int base = 0; base < R * CPR; base += THREADS) {
    const int i = base + threadIdx.x;
    const int r = i / CPR, c = (i % CPR) * 8;
    float part = 0.f;
    if (r < valid) {
      uint4 va = *reinterpret_cast<const uint4*>(a + (long long)(row0 + r) * a_sl + c);
      uint4 vb = *reinterpret_cast<const uint4*>(b + (long long)(row0 + r) * b_sl + c);
      const bf16* ea = reinterpret_cast<const bf16*>(&va);
      const bf16* eb = reinterpret_cast<const bf16*>(&vb);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        part += __bfloat162float(ea[j]) * __bfloat162float(eb[j]);
    }
#pragma unroll
    for (int off = CPR / 2; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (i % CPR == 0) out[r] = part;
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Keys a q tile starting at q0 must visit.
__device__ __forceinline__ int key_end(const Params& p, int q0) {
  return p.causal ? min(p.L, q0 + BM) : p.L;
}

template <int D> constexpr size_t fwd_smem() {
  return sizeof(bf16) * ((BM + BN) * (D + 8) + D * LDN);
}
template <int D> constexpr size_t dq_smem() {
  return sizeof(bf16) * ((2 * BM + 2 * BN) * (D + 8) + D * LDN) +
         sizeof(float) * 2 * BM;
}
template <int D> constexpr size_t dkv_smem() {
  return sizeof(bf16) * ((2 * BM + 2 * BN) * (D + 8) + 2 * D * LDN) +
         sizeof(float) * 2 * BN;
}

// ------------------------------------------------------------------ forward
// One block: 64 query rows of one (batch, head); each warp owns 16 rows and
// keeps its q fragments, running max/denominator and output in registers.
template <int D>
__global__ void __launch_bounds__(THREADS) fwd_kernel(const Params p) {
  constexpr int LDD = D + 8;  // padded row: conflict-free fragment loads
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BM * LDD;
  bf16* sVt = sK + BN * LDD;

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BM;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int kvh = h / (p.H / p.KVH);
  const bf16* qg = p.q.p + b * p.q.sb + h * p.q.sh;
  const bf16* kg = p.k.p + b * p.k.sb + kvh * p.k.sh;
  const bf16* vg = p.v.p + b * p.v.sb + kvh * p.v.sh;

  load_tile<D, BM>(sQ, LDD, nullptr, qg, p.q.sl, q0, p.L - q0);
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) load_a(qf[kk], sQ, LDD, w * 16, kk * 16, lane);

  const int row[2] = {q0 + w * 16 + g, q0 + w * 16 + g + 8};
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  const int kend = key_end(p, q0);
  for (int k0 = 0; k0 < kend; k0 += BN) {
    __syncthreads();
    load_tile<D, BN>(sK, LDD, nullptr, kg, p.k.sl, k0, p.L - k0);
    load_tile<D, BN>(nullptr, 0, sVt, vg, p.v.sl, k0, p.L - k0);
    __syncthreads();

    float s[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t bf[2];
        load_b(bf, sK, LDD, n * 8, kk * 16, lane);
        mma16816(s[n], qf[kk], bf);
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + t * 2 + (e & 1);
        const int r = row[e >> 1];
        const bool ok = col < p.L && (!p.causal || r >= col);
        s[n][e] = ok ? s[n][e] * p.scale : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      alpha[i] = expf(m[i] - mx[i]);
    }
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - mx[e >> 1]);
        rs[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] = alpha[i] * l[i] + quad_sum(rs[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      acc[dn][0] *= alpha[0]; acc[dn][1] *= alpha[0];
      acc[dn][2] *= alpha[1]; acc[dn][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t pa[4];
      c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        uint32_t bf[2];
        load_b(bf, sVt, LDN, dn * 8, kk * 16, lane);
        mma16816(acc[dn], pa, bf);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= p.L) continue;
    const float l_safe = fmaxf(l[i], 1e-30f), inv = 1.f / l_safe;
    bf16* o = p.o_out + (((long long)b * p.L + row[i]) * p.H + h) * D;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<uint32_t*>(o + dn * 8 + t * 2) =
          pack_bf16(acc[dn][2 * i] * inv, acc[dn][2 * i + 1] * inv);
    if (t == 0)
      p.lse_out[((long long)b * p.H + h) * p.L + row[i]] = m[i] + logf(l_safe);
  }
}

// ------------------------------------------------------------- backward dq
// One block: 64 query rows of one (batch, head). dq += (p * (dO.V^T - D)).K
// over the key tiles up to the diagonal; p = exp(s - lse) from the saved lse.
template <int D>
__global__ void __launch_bounds__(THREADS) bwd_dq_kernel(const Params p) {
  constexpr int LDD = D + 8;  // padded row: conflict-free fragment loads
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sDO = sQ + BM * LDD;
  bf16* sK = sDO + BM * LDD;
  bf16* sV = sK + BN * LDD;
  bf16* sKt = sV + BN * LDD;
  float* sLse = reinterpret_cast<float*>(sKt + D * LDN);
  float* sDelta = sLse + BM;

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BM;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int kvh = h / (p.H / p.KVH);
  const bf16* qg = p.q.p + b * p.q.sb + h * p.q.sh;
  const bf16* dog = p.dout.p + b * p.dout.sb + h * p.dout.sh;
  const bf16* og = p.o.p + b * p.o.sb + h * p.o.sh;
  const bf16* kg = p.k.p + b * p.k.sb + kvh * p.k.sh;
  const bf16* vg = p.v.p + b * p.v.sb + kvh * p.v.sh;
  const float* lseg = p.lse_in + ((long long)b * p.H + h) * p.L;

  load_tile<D, BM>(sQ, LDD, nullptr, qg, p.q.sl, q0, p.L - q0);
  load_tile<D, BM>(sDO, LDD, nullptr, dog, p.dout.sl, q0, p.L - q0);
  row_dot<D, BM>(sDelta, dog, p.dout.sl, og, p.o.sl, q0, p.L - q0);
  for (int i = threadIdx.x; i < BM; i += THREADS)
    sLse[i] = q0 + i < p.L ? lseg[q0 + i] : 0.f;
  __syncthreads();

  uint32_t qf[D / 16][4], dof[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    load_a(qf[kk], sQ, LDD, w * 16, kk * 16, lane);
    load_a(dof[kk], sDO, LDD, w * 16, kk * 16, lane);
  }
  const int row[2] = {q0 + w * 16 + g, q0 + w * 16 + g + 8};
  const float lse[2] = {sLse[w * 16 + g], sLse[w * 16 + g + 8]};
  const float delta[2] = {sDelta[w * 16 + g], sDelta[w * 16 + g + 8]};
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  const int kend = key_end(p, q0);
  for (int k0 = 0; k0 < kend; k0 += BN) {
    __syncthreads();
    load_tile<D, BN>(sK, LDD, sKt, kg, p.k.sl, k0, p.L - k0);
    load_tile<D, BN>(sV, LDD, nullptr, vg, p.v.sl, k0, p.L - k0);
    __syncthreads();

    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t bf[2];
        load_b(bf, sK, LDD, n * 8, kk * 16, lane);
        mma16816(s[n], qf[kk], bf);
        load_b(bf, sV, LDD, n * 8, kk * 16, lane);
        mma16816(dp[n], dof[kk], bf);
      }
    }
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + t * 2 + (e & 1);
        const int i = e >> 1;
        const bool ok = col < p.L && (!p.causal || row[i] >= col);
        const float pr = expf((ok ? s[n][e] * p.scale : NEG_INF) - lse[i]);
        s[n][e] = pr * (dp[n][e] - delta[i]);  // ds
      }
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t da[4];
      c_to_a(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        uint32_t bf[2];
        load_b(bf, sKt, LDN, dn * 8, kk * 16, lane);
        mma16816(acc[dn], da, bf);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= p.L) continue;
    bf16* dq = p.dq + (((long long)b * p.L + row[i]) * p.H + h) * D;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<uint32_t*>(dq + dn * 8 + t * 2) =
          pack_bf16(acc[dn][2 * i] * p.scale, acc[dn][2 * i + 1] * p.scale);
  }
}

// ------------------------------------------------------------ backward dkv
// One block: 64 keys of one (batch, kv head). It loops over the H/KVH query
// heads of the group and, from the diagonal on, over their q tiles, so the
// sum over the group is taken in registers: no atomics, no per-q-head dk.
// Each warp owns 16 keys and computes s^T = K.Q^T and dp^T = V.dO^T.
template <int D>
__global__ void __launch_bounds__(THREADS) bwd_dkv_kernel(const Params p) {
  constexpr int LDD = D + 8;  // padded row: conflict-free fragment loads
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BM * LDD;
  bf16* sQ = sV + BM * LDD;
  bf16* sDO = sQ + BN * LDD;
  bf16* sQt = sDO + BN * LDD;
  bf16* sDOt = sQt + D * LDN;
  float* sLse = reinterpret_cast<float*>(sDOt + D * LDN);
  float* sDelta = sLse + BN;

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BM;
  const int b = blockIdx.y / p.KVH, kvh = blockIdx.y % p.KVH;
  const int reps = p.H / p.KVH;
  const bf16* kg = p.k.p + b * p.k.sb + kvh * p.k.sh;
  const bf16* vg = p.v.p + b * p.v.sb + kvh * p.v.sh;

  load_tile<D, BM>(sK, LDD, nullptr, kg, p.k.sl, k0, p.L - k0);
  load_tile<D, BM>(sV, LDD, nullptr, vg, p.v.sl, k0, p.L - k0);
  __syncthreads();
  uint32_t kf[D / 16][4], vf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    load_a(kf[kk], sK, LDD, w * 16, kk * 16, lane);
    load_a(vf[kk], sV, LDD, w * 16, kk * 16, lane);
  }
  const int key[2] = {k0 + w * 16 + g, k0 + w * 16 + g + 8};
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dn][e] = dv[dn][e] = 0.f;

  // q tiles strictly before this key tile never attend to it.
  const int qstart = p.causal ? (k0 / BN) * BN : 0;
  for (int r = 0; r < reps; ++r) {
    const int h = kvh * reps + r;
    const bf16* qg = p.q.p + b * p.q.sb + h * p.q.sh;
    const bf16* dog = p.dout.p + b * p.dout.sb + h * p.dout.sh;
    const bf16* og = p.o.p + b * p.o.sb + h * p.o.sh;
    const float* lseg = p.lse_in + ((long long)b * p.H + h) * p.L;
    for (int qs = qstart; qs < p.L; qs += BN) {
      __syncthreads();
      load_tile<D, BN>(sQ, LDD, sQt, qg, p.q.sl, qs, p.L - qs);
      load_tile<D, BN>(sDO, LDD, sDOt, dog, p.dout.sl, qs, p.L - qs);
      row_dot<D, BN>(sDelta, dog, p.dout.sl, og, p.o.sl, qs, p.L - qs);
      for (int i = threadIdx.x; i < BN; i += THREADS)
        sLse[i] = qs + i < p.L ? lseg[qs + i] : 0.f;
      __syncthreads();

      float st[BN / 8][4], dpt[BN / 8][4];
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t bf[2];
          load_b(bf, sQ, LDD, n * 8, kk * 16, lane);
          mma16816(st[n], kf[kk], bf);
          load_b(bf, sDO, LDD, n * 8, kk * 16, lane);
          mma16816(dpt[n], vf[kk], bf);
        }
      }
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = n * 8 + t * 2 + (e & 1);
          const int qpos = qs + qi;
          const bool ok = qpos < p.L && (!p.causal || qpos >= key[e >> 1]);
          const float pr = expf((ok ? st[n][e] * p.scale : NEG_INF) - sLse[qi]);
          st[n][e] = pr;                                 // p^T
          dpt[n][e] = pr * (dpt[n][e] - sDelta[qi]);     // ds^T
        }
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        uint32_t pa[4], da[4];
        c_to_a(pa, st[2 * kk], st[2 * kk + 1]);
        c_to_a(da, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          uint32_t bf[2];
          load_b(bf, sDOt, LDN, dn * 8, kk * 16, lane);
          mma16816(dv[dn], pa, bf);
          load_b(bf, sQt, LDN, dn * 8, kk * 16, lane);
          mma16816(dk[dn], da, bf);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= p.L) continue;
    const long long off = (((long long)b * p.L + key[i]) * p.KVH + kvh) * D;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      *reinterpret_cast<uint32_t*>(p.dk + off + dn * 8 + t * 2) =
          pack_bf16(dk[dn][2 * i] * p.scale, dk[dn][2 * i + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(p.dv + off + dn * 8 + t * 2) =
          pack_bf16(dv[dn][2 * i], dv[dn][2 * i + 1]);
    }
  }
}

enum Kind { FWD = 0, BWD_DQ = 1, BWD_DKV = 2 };

template <int D>
size_t smem_bytes(int kind) {
  return kind == FWD ? fwd_smem<D>() : kind == BWD_DQ ? dq_smem<D>() : dkv_smem<D>();
}

template <int D>
cudaError_t launch(int kind, const Params& p, cudaStream_t stream) {
  void (*kernel)(const Params) = fwd_kernel<D>;
  if (kind == BWD_DQ) kernel = bwd_dq_kernel<D>;
  if (kind == BWD_DKV) kernel = bwd_dkv_kernel<D>;
  const size_t smem = smem_bytes<D>(kind);
  // The shared-memory limit is an attribute of the kernel on each device:
  // set it at a kernel's first launch on a device, not at every launch.
  constexpr int MAX_DEVICES = 64;
  static bool configured[3][MAX_DEVICES] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!configured[kind][device]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured[kind][device] = true;
  }
  const int rows = kind == BWD_DKV ? p.B * p.KVH : p.B * p.H;
  dim3 grid((p.L + BM - 1) / BM, rows);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch(int kind, int d, const Params& p, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<16>(kind, p, stream);
    case 32: return launch<32>(kind, p, stream);
    case 64: return launch<64>(kind, p, stream);
    case 128: return launch<128>(kind, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

View view(const void* ptr, long long sb, long long sl, long long sh) {
  return View{static_cast<const bf16*>(ptr), sb, sl, sh};
}

}  // namespace

extern "C" {

const char* rtt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory of one block of `kind` (0 fwd, 1 dq, 2 dkv), or 0
// for an unsupported head dim.
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
  Params p = {};
  p.q = view(q, q_sb, q_sl, q_sh);
  p.k = view(k, k_sb, k_sl, k_sh);
  p.v = view(v, v_sb, v_sl, v_sh);
  p.o_out = static_cast<bf16*>(o);
  p.lse_out = static_cast<float*>(lse);
  p.B = B; p.L = L; p.H = H; p.KVH = KVH; p.causal = causal; p.scale = scale;
  return (int)dispatch(FWD, D, p, static_cast<cudaStream_t>(stream));
}

// kind 1 writes dq; kind 2 writes dk and dv.
int rtt_flash_bwd(int kind, const void* q, const void* k, const void* v,
                  const void* o, const void* lse, const void* dout, void* dq,
                  void* dk, void* dv, int B, int L, int H, int KVH, int D,
                  int causal, float scale,
                  long long q_sb, long long q_sl, long long q_sh,
                  long long k_sb, long long k_sl, long long k_sh,
                  long long v_sb, long long v_sl, long long v_sh,
                  long long o_sb, long long o_sl, long long o_sh,
                  long long do_sb, long long do_sl, long long do_sh,
                  void* stream) {
  if (kind != BWD_DQ && kind != BWD_DKV) return (int)cudaErrorInvalidValue;
  Params p = {};
  p.q = view(q, q_sb, q_sl, q_sh);
  p.k = view(k, k_sb, k_sl, k_sh);
  p.v = view(v, v_sb, v_sl, v_sh);
  p.o = view(o, o_sb, o_sl, o_sh);
  p.dout = view(dout, do_sb, do_sl, do_sh);
  p.lse_in = static_cast<const float*>(lse);
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.B = B; p.L = L; p.H = H; p.KVH = KVH; p.causal = causal; p.scale = scale;
  return (int)dispatch(kind, D, p, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
