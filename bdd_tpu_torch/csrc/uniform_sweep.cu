// Hopper (sm_90a) sweep kernels of the bucketed uniform dual solver.
//
// Replace the Pallas TPU kernels of bdd_tpu/solver/pallas_uniform.py:
//   uniform_forward  <- _forward_kernel  (pallas_uniform.py:112-180)
//   uniform_backward <- _backward_kernel (pallas_uniform.py:183-246)
// One launch runs the whole half-sweep of EVERY bucket of up to 32 slots of
// a solve, a second one that of the wide buckets (the wide section), a third
// one that of the huge buckets whose rows fit a block's shared memory (the
// huge section: the wider ones, and the wide ones from the plan's crossover
// up to 8,192 slots), a fourth one that of the buckets whose rows fit the
// shared memory of a cluster of blocks (the cluster body) and a fifth one
// that of the rest (the L2 body): per hop
// the min-marginals, the MMA cost update, and the frontier (forward cfr) or
// costs-to-terminal (backward cft). uniform_backward_run is the backward body
// without the cost update: the costs-to-terminal of given costs
// (bucket_backward_run, bdd_tpu/solver/uniform.py:1208), which the JAX
// package runs as a scan inside its jitted programs. Semantics are those of the XLA scan in
// bdd_tpu/solver/uniform.py:1181-1373 and of the torch twins in
// bdd_tpu_torch/solver/uniform.py, with real IEEE infinities (not the Pallas
// BIG=1e30 stand-in).
//
// Bound: bytes (device memory). Per (hop, column) the kernel reads one geometry record of
// max(4, 2P) bytes, P frontier values and five (six with a per-layer omega)
// cost values, and writes 3 + P values; a few dozen compares and adds. The
// least time is those bytes over the card's memory rate.
//
// Design, and what each point is for.
//  * Columns are independent and the hop loop is a serial recurrence, so one
//    thread owns one column and keeps its P-slot frontier in registers
//    (template on P, fully unrolled compare-selects, no indexed registers).
//  * The addresses of all later hops are known at entry; only the arithmetic
//    is serial. So the loads run ahead of the hop loop: every thread copies
//    the inputs of its own column's next S hops into a ring of S + 1 slots
//    in shared memory (one cell a column and slot) with cp.async (4, 8 or 16
//    bytes a copy) and waits with cp.async.wait_group only for the hop it is
//    about to compute. A thread reads back only what it copied itself, so
//    the ring needs no block barrier, a ragged last tile is just a thread
//    that leaves, and every copy is naturally aligned (a value, or a record
//    of 4, 8 or 16k bytes). The extra slot is the one the arithmetic is
//    still reading. Outputs go straight to device memory. Backward walks the
//    hops from H-1 down; the forward ring carries cft of hop h+1 in the slot
//    of hop h. Pointers into device memory run along, one hop a step, and
//    every offset inside a cell is a compile-time constant: what is left of
//    a hop is its arithmetic, one dependent chain, which is what a warp
//    alone on its scheduler is then held by (warm, about half the byte
//    bound at 13,696 columns; wider layouts with more warps come closer).
//  * A block is a tile of 32 or 64 columns, one thread each, sized by the
//    caller from the total column count. Depth of prefetch, not thread
//    count, carries the memory latency of narrow buckets.
//  * A table in device memory (P, H, B, first block, offsets into the flat
//    buffers, stages) lets one grid cover all buckets; a block looks up its
//    bucket and switches on P into the templated body. Kernels are
//    instantiated for a largest P of 2, 8 and 32, so that narrow solves are
//    not held to the register count of the widest body.
//  * Geometry comes as bytes: per (hop, column) a record [lo arc of slot
//    0..P-1, hi arc of slot 0..P-1, padding to 4]; an arc byte is kind (2
//    bits) | slot << 2 (5 bits) | flag << 7. The flag of a lo byte is
//    node_valid; of record byte P layer_valid; of record byte P+1 root.
//    solver/layout.py writes this form and the twins decode the same bytes.
//    Buckets of more than 32 slots carry two bytes an arc and have a body of
//    their own (the wide section), and those of more than 8,192 four bytes
//    and a block a column (the huge section): this one holds a column's P
//    frontier values in registers and does not stretch past P = 32.
//
// Build: nvcc without --use_fast_math (isinf/isnan must hold) and with
// -fmad=false (no FMA contraction), so results match the twin bit for bit.
// The C interface: one entry per half-sweep (and the run) and precision,
// which takes the launches of a plan as records (Launch, one a body, in the
// plan's order; solver/layout.py builds them, route and all) and the
// buffers (Buffers), and launches the records in order on the caller's
// stream; one occupancy entry per precision. A launch returns
// cudaGetLastError(), -1 for a largest P with no instantiation (or an L2
// launch without its scratch, a counting form without its accumulator, or
// shared memory past the opt-in), -2 for a tile that is not 32 or 64
// columns (a block size the wide or huge body does not take, a huge bucket
// too wide for a slot code, a ring form over a bucket wider than its
// threads, or an L2 split the body does not take), or the code of a launch
// the card refused (a cooperative L2 grid it cannot place at once); the
// entry stops at the first record that fails and names it.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

// the bodies, in the order of layout.BODIES
enum Body { BODY_NARROW, BODY_WIDE, BODY_HUGE, BODY_CLUSTER, BODY_L2 };

// one launch of a sweep body over its table (layout.BodyLaunch; mirrored by
// _build.Launch): the dynamic shared memory a block of the forward and of
// the backward and run, the body's own two integers (narrow: tile, widest
// bucket; wide: warps a block, bytes a warp; huge: widest bucket, ring hops
// or 0; cluster: C, widest bucket; L2: G, columns), the L2 body's scratch
// (the forward's key rows, the partials, the counters) and `acc`: null for
// the body's own kernel, else the pair of 64-bit accumulators of its
// counting form (the huge and the L2 body)
struct Launch {
  const void* table;
  int body;
  int nr_buckets;
  int blocks;
  int threads;
  int smem_forward;
  int smem_backward;
  int own[2];
  void* rows;
  void* partials;
  void* counters;
  unsigned long long* acc;
};

// the buffers of a half-sweep or a run, flat over the buckets of every table
// (mirrored by _build.Buffers); the run reads arcs, lo and hi and writes
// out_frontier, its other buffers null
struct Buffers {
  const void* arcs;
  const void* lo;
  const void* hi;
  const void* din_lo;
  const void* din_hi;
  const void* alpha;
  const void* omega_arr;
  double omega;
  const void* frontier;
  void* out_lo;
  void* out_hi;
  void* out_mm;
  void* out_frontier;
};

namespace {

constexpr int ARC_INTERNAL = 0;
constexpr int ARC_TOP = 1;
constexpr int ARC_BOT = 2;
constexpr int MAX_TILE = 64;
constexpr int MAX_STAGES = 8;
constexpr int LAYER_ROWS = 6;  // lo hi din_lo din_hi alpha omega

// one row of the bucket table (int64 [nr_buckets, 8], solver/layout.py)
struct Bucket {
  long long P, H, B;
  long long first_block;  // first block of the grid that works on it
  long long row_off;      // elements, into the [H, B] buffers
  long long node_off;     // elements, into the frontier buffers
  long long arc_off;      // bytes, into the geometry records
  long long stages;       // hops in flight: 1..MAX_STAGES (narrow), 0..MAX_STAGES (wide);
                          // huge: the backward's rows in shared memory, 1 or 2;
                          // L2: the offset into the scratch rows
};

template <typename T>
struct Args {
  const Bucket* __restrict__ table;
  int nr_buckets;
  const uint8_t* __restrict__ arcs;  // records [H, B, max(4, 2P)] per bucket
  const T* __restrict__ lo;          // [H, B] per bucket, flat
  const T* __restrict__ hi;
  const T* __restrict__ din_lo;
  const T* __restrict__ din_hi;
  const T* __restrict__ alpha;
  const T* __restrict__ omega_arr;  // [H, B] or null: scalar omega
  T omega;
  // frontiers: [H, P, B] per narrow bucket, [H, B, P] per wide bucket
  const T* __restrict__ frontier;  // cft (forward) / cfr (backward) / null (run)
  T* __restrict__ out_lo;
  T* __restrict__ out_hi;
  T* __restrict__ out_mm;
  T* __restrict__ out_frontier;  // cfr (forward) / cft (backward, run)
};

template <typename T>
__device__ __forceinline__ T inf_v() {
  return T(INFINITY);
}

// NaN-propagating min/max, as torch.minimum / clamp_min
template <typename T>
__device__ __forceinline__ T min_v(T a, T b) {
  return (a != a || a < b) ? a : b;
}

template <typename T>
__device__ __forceinline__ T max_v(T a, T b) {
  return (a != a || a > b) ? a : b;
}

// float has both as one instruction (NaN-propagating min / max, sm_80 on)
template <>
__device__ __forceinline__ float min_v<float>(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

template <>
__device__ __forceinline__ float max_v<float>(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// MMA update of one layer (uniform.py:1181-1205). Forcing deltas (±inf din)
// are added unscaled, so alpha <= 1/3 keeps them infinite.
template <typename T>
__device__ __forceinline__ void hop_cost_update(T lo, T hi, T m0, T m1, T omega,
                                                T alpha, T din_lo, T din_hi,
                                                bool lval, T& new_lo, T& new_hi,
                                                T& def_mm) {
  const T inf = inf_v<T>();
  const bool fin0 = isfinite(m0), fin1 = isfinite(m1), both = fin0 && fin1;
  T diff = both ? m1 - m0 : T(0);
  if (isnan(diff)) diff = T(0);
  const T mm = omega * diff;
  const bool dfin0 = isfinite(din_lo), dfin1 = isfinite(din_hi);
  const T dlo = alpha * (dfin0 ? din_lo : T(0)) + (dfin0 ? T(0) : din_lo);
  const T dhi = alpha * (dfin1 ? din_hi : T(0)) + (dfin1 ? T(0) : din_hi);
  const T nl = (fin0 ? lo - max_v(-mm, T(0)) : inf) + dlo;
  const T nh = (fin1 ? hi - max_v(mm, T(0)) : inf) + dhi;
  const T dm = both ? mm : (fin1 ? -inf : inf);
  new_lo = lval ? nl : T(0);
  new_hi = lval ? nh : T(0);
  def_mm = lval ? dm : T(0);
}

// ---------------------------------------------------------------- cp.async
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
                 : "memory");
  else if constexpr (BYTES == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem)
                 : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` of this thread's newest groups are in flight
__device__ __forceinline__ void cp_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    case 7: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 8;\n" ::: "memory"); break;
  }
}

// ------------------------------------------------------------ ring layout
// A slot holds one hop of the block's tile, one cell of W bytes a column:
//   [geometry record, G bytes][padding to a value][LAYER_ROWS + P values]
// All offsets inside a cell are compile-time constants, so the hop loop
// spends no instruction on shared-memory addresses. W is padded to an odd
// count of 4-byte (8-byte) units where its alignment allows, so that a warp's
// cells fall into distinct banks. solver/layout.py computes the same W.
template <int P>
struct Record {
  static constexpr int G = 2 * P < 4 ? 4 : 2 * P;  // bytes
  static constexpr int WORDS = G / 4;
  static constexpr int CHUNKS = G / 16;  // 0 for G of 4 and 8
};

template <typename T, int P>
struct Cell {
  static constexpr int G = Record<P>::G;
  static constexpr int SZ = (int)sizeof(T);
  static constexpr int VALUES = (G + SZ - 1) / SZ * SZ;  // offset of the values
  static constexpr int ALIGN = G >= 16 ? 16 : ((G == 8 || SZ == 8) ? 8 : 4);
  static constexpr int RAW = (VALUES + (LAYER_ROWS + P) * SZ + ALIGN - 1) / ALIGN * ALIGN;
  static constexpr int W =
      (ALIGN < 16 && (RAW / ALIGN) % 2 == 0) ? RAW + ALIGN : RAW;

  __device__ static __forceinline__ const T& value(const unsigned char* cell, int r) {
    return *(const T*)(cell + VALUES + r * SZ);
  }
  __device__ static __forceinline__ void* value_at(unsigned char* cell, int r) {
    return cell + VALUES + r * SZ;
  }
  // the record as words in registers
  __device__ static __forceinline__ void load_record(const unsigned char* cell,
                                                     uint32_t (&w)[Record<P>::WORDS]) {
    if constexpr (G == 4) {
      w[0] = *(const uint32_t*)cell;
    } else if constexpr (G == 8) {
      const uint2 v = *(const uint2*)cell;
      w[0] = v.x;
      w[1] = v.y;
    } else {
#pragma unroll
      for (int j = 0; j < Record<P>::CHUNKS; ++j) {
        const uint4 v = *(const uint4*)(cell + 16 * j);
        w[4 * j] = v.x;
        w[4 * j + 1] = v.y;
        w[4 * j + 2] = v.z;
        w[4 * j + 3] = v.w;
      }
    }
  }
};

template <int WORDS>
__device__ __forceinline__ int record_byte(const uint32_t (&w)[WORDS], int i) {
  return (int)((w[i >> 2] >> ((i & 3) * 8)) & 0xffu);
}

// ------------------------------------------------------------------ bodies
// MODE of a body: the forward half-sweep, the backward half-sweep, or the
// backward RUN: costs-to-terminal of the given costs with no cost update
// (bucket_backward_run, bdd_tpu/solver/uniform.py:1208). The run is the
// backward relaxation with new costs = old costs; it reads the records, lo
// and hi and writes only the frontier.
constexpr int MODE_FORWARD = 0;
constexpr int MODE_BACKWARD = 1;
constexpr int MODE_BACKWARD_RUN = 2;

template <typename T, int P, int MODE>
__device__ __forceinline__ void sweep_column(const Args<T>& a, const Bucket& bk,
                                             unsigned char* smem, int tile_index) {
  using C = Cell<T, P>;
  constexpr int G = C::G, SZ = C::SZ;
  constexpr bool FORWARD = MODE == MODE_FORWARD, RUN = MODE == MODE_BACKWARD_RUN;
  const int tile = (int)blockDim.x, t = (int)threadIdx.x;  // one thread a column of the tile
  const int H = (int)bk.H, B = (int)bk.B;
  const int b = tile_index * tile + t;
  // no barrier below: a thread reads only its own copies
  if (b >= B) return;
  const T inf = inf_v<T>();
  const int S = min((int)bk.stages, MAX_STAGES), NS = S + 1;
  const int slot_stride = tile * C::W;
  unsigned char* const ring = smem + t * C::W;  // this column's cell of slot 0

  // Step i works on hop h(i): forward i, backward H-1-i. Running pointers,
  // moved by one hop a step: g_* at the next hop to copy, o_* at the hop
  // being computed. The frontier rows riding with a step are those of hop
  // h+1 (forward; none with the last hop) or of hop h (backward).
  const ptrdiff_t step = FORWARD ? (ptrdiff_t)B : -(ptrdiff_t)B;
  const size_t first = (size_t)(FORWARD ? 0 : H - 1) * B + b;
  const size_t row0 = (size_t)bk.row_off + first;
  const uint8_t* g_rec = a.arcs + bk.arc_off + first * G;
  const T* g_lo = a.lo + row0;
  const T* g_hi = a.hi + row0;
  // the run has none of these (null pointers): never formed into addresses
  const T* g_dl = RUN ? nullptr : a.din_lo + row0;
  const T* g_dh = RUN ? nullptr : a.din_hi + row0;
  const T* g_al = RUN ? nullptr : a.alpha + row0;
  const T* g_om = !RUN && a.omega_arr ? a.omega_arr + row0 : nullptr;
  const T* g_fr =
      RUN ? nullptr : a.frontier + bk.node_off + (size_t)(FORWARD ? 1 : H - 1) * P * B + b;
  T* o_lo = RUN ? nullptr : a.out_lo + row0;
  T* o_hi = RUN ? nullptr : a.out_hi + row0;
  T* o_mm = RUN ? nullptr : a.out_mm + row0;
  T* o_fr = a.out_frontier + bk.node_off + first * P - (size_t)b * (P - 1);

  auto start_copies = [&](int i, unsigned char* cell) {  // called for i = 0, 1, 2, ...
    if constexpr (G == 4) {
      cp_async<4>(cell, g_rec);
    } else if constexpr (G == 8) {
      cp_async<8>(cell, g_rec);
    } else {
#pragma unroll
      for (int j = 0; j < Record<P>::CHUNKS; ++j) cp_async<16>(cell + 16 * j, g_rec + 16 * j);
    }
    cp_async<SZ>(C::value_at(cell, 0), g_lo);
    cp_async<SZ>(C::value_at(cell, 1), g_hi);
    g_rec += step * G;
    g_lo += step;
    g_hi += step;
    if constexpr (!RUN) {
      cp_async<SZ>(C::value_at(cell, 2), g_dl);
      cp_async<SZ>(C::value_at(cell, 3), g_dh);
      cp_async<SZ>(C::value_at(cell, 4), g_al);
      if (g_om) {
        cp_async<SZ>(C::value_at(cell, 5), g_om);
        g_om += step;
      }
      if (!FORWARD || i + 1 < H) {
#pragma unroll
        for (int p = 0; p < P; ++p)
          cp_async<SZ>(C::value_at(cell, LAYER_ROWS + p), g_fr + (size_t)p * B);
      }
      g_dl += step;
      g_dh += step;
      g_al += step;
      g_fr += step * P;
    }
  };
  for (int s = 0; s < S; ++s) {
    if (s < H) start_copies(s, ring + s * slot_stride);
    cp_commit();  // one group a step, empty or not, so the count stays even
  }

  T fr[P];  // forward: cfr of this hop; backward: cft of hop h+1
#pragma unroll
  for (int p = 0; p < P; ++p) fr[p] = inf;

  int s_cur = 0, s_next = S;
  for (int i = 0; i < H; ++i) {
    // refill the slot step i-1 read, then wait for step i's own group:
    // S + i + 1 groups are committed, group i must be done, S may pend
    if (i + S < H) start_copies(i + S, ring + s_next * slot_stride);
    cp_commit();
    cp_wait(S);
    const unsigned char* cell = ring + s_cur * slot_stride;
    s_next = s_cur;
    s_cur = s_cur + 1 == NS ? 0 : s_cur + 1;

    uint32_t w[Record<P>::WORDS];
    C::load_record(cell, w);
    const bool lval = (record_byte(w, P) >> 7) != 0;
    const T lo = C::value(cell, 0), hi = C::value(cell, 1);
    const T om = !RUN && a.omega_arr ? C::value(cell, 5) : a.omega;
    T nl = lo, nh = hi, mm = T(0);

    if constexpr (FORWARD) {
      if (record_byte(w, P + 1) >> 7) {  // root restart (also the hop-0 init)
#pragma unroll
        for (int p = 0; p < P; ++p) fr[p] = p == 0 ? T(0) : inf;
      }
      const bool last = i + 1 >= H;
      T m0 = inf, m1 = inf;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int lb = record_byte(w, p), hb = record_byte(w, P + p);
        const int lk = lb & 3, ls = (lb >> 2) & 31, hk = hb & 3, hs = (hb >> 2) & 31;
        // cft of the child: TOP -> 0, BOT -> inf, else cft[h+1][slot]
        // (inf past the last hop; 0 for a slot outside the bucket, as the
        // twin's gather gives)
        const T gl = last ? inf : (ls < P ? C::value(cell, LAYER_ROWS + ls) : T(0));
        const T gh = last ? inf : (hs < P ? C::value(cell, LAYER_ROWS + hs) : T(0));
        const T tl = lk == ARC_TOP ? T(0) : (lk == ARC_BOT ? inf : gl);
        const T th = hk == ARC_TOP ? T(0) : (hk == ARC_BOT ? inf : gh);
        const bool nv = (lb >> 7) != 0;
        m0 = min_v(m0, nv ? fr[p] + lo + tl : inf);
        m1 = min_v(m1, nv ? fr[p] + hi + th : inf);
      }
      hop_cost_update(lo, hi, m0, m1, om, C::value(cell, 4), C::value(cell, 2),
                      C::value(cell, 3), lval, nl, nh, mm);
#pragma unroll
      for (int p = 0; p < P; ++p) o_fr[(size_t)p * B] = fr[p];
      // relax the frontier to h+1: nxt[k] = min over valid p with an
      // internal arc into k of cfr[p] + cost of that arc
      T nxt[P];
#pragma unroll
      for (int k = 0; k < P; ++k) nxt[k] = inf;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int lb = record_byte(w, p), hb = record_byte(w, P + p);
        const int lk = lb & 3, ls = (lb >> 2) & 31, hk = hb & 3, hs = (hb >> 2) & 31;
        const bool nv = (lb >> 7) != 0;
        const T vl = nv && lk == ARC_INTERNAL ? fr[p] + nl : inf;
        const T vh = nv && hk == ARC_INTERNAL ? fr[p] + nh : inf;
#pragma unroll
        for (int k = 0; k < P; ++k) {
          if (ls == k) nxt[k] = min_v(nxt[k], vl);
          if (hs == k) nxt[k] = min_v(nxt[k], vh);
        }
      }
#pragma unroll
      for (int k = 0; k < P; ++k) fr[k] = nxt[k];
    } else {
      bool nv[P];
      T tl[P], th[P];
      T m0 = inf, m1 = inf;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int lb = record_byte(w, p), hb = record_byte(w, P + p);
        const int lk = lb & 3, ls = (lb >> 2) & 31, hk = hb & 3, hs = (hb >> 2) & 31;
        T gl = T(0), gh = T(0);
#pragma unroll
        for (int k = 0; k < P; ++k) {
          gl = ls == k ? fr[k] : gl;
          gh = hs == k ? fr[k] : gh;
        }
        tl[p] = lk == ARC_TOP ? T(0) : (lk == ARC_BOT ? inf : gl);
        th[p] = hk == ARC_TOP ? T(0) : (hk == ARC_BOT ? inf : gh);
        nv[p] = (lb >> 7) != 0;
        if constexpr (!RUN) {
          const T cf = C::value(cell, LAYER_ROWS + p);
          m0 = min_v(m0, nv[p] ? cf + lo + tl[p] : inf);
          m1 = min_v(m1, nv[p] ? cf + hi + th[p] : inf);
        }
      }
      if constexpr (!RUN)
        hop_cost_update(lo, hi, m0, m1, om, C::value(cell, 4), C::value(cell, 2),
                        C::value(cell, 3), lval, nl, nh, mm);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        fr[p] = nv[p] ? min_v(nl + tl[p], nh + th[p]) : inf;
        o_fr[(size_t)p * B] = fr[p];
      }
    }
    if constexpr (!RUN) {
      *o_lo = nl;
      *o_hi = nh;
      *o_mm = mm;
      o_lo += step;
      o_hi += step;
      o_mm += step;
    }
    o_fr += step * P;
  }
}

// `launch` admits only a pmax of SUPPORTED P and the caller's table holds no
// P above it (solver/sweep_kernels.py checks every row), so each block finds
// its case below.
template <typename T, int MODE, int PMAX>
__global__ void __launch_bounds__(MAX_TILE) sweep_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int k = 0;
  while (k + 1 < a.nr_buckets && (long long)blockIdx.x >= a.table[k + 1].first_block) ++k;
  const Bucket bk = a.table[k];
  const int tile_index = (int)((long long)blockIdx.x - bk.first_block);
  switch ((int)bk.P) {
    case 1: sweep_column<T, 1, MODE>(a, bk, smem, tile_index); break;
    case 2: sweep_column<T, 2, MODE>(a, bk, smem, tile_index); break;
    case 4: if constexpr (PMAX >= 4) sweep_column<T, 4, MODE>(a, bk, smem, tile_index); break;
    case 8: if constexpr (PMAX >= 8) sweep_column<T, 8, MODE>(a, bk, smem, tile_index); break;
    case 16: if constexpr (PMAX >= 16) sweep_column<T, 16, MODE>(a, bk, smem, tile_index); break;
    case 32: if constexpr (PMAX >= 32) sweep_column<T, 32, MODE>(a, bk, smem, tile_index); break;
    default: break;
  }
}

// the narrow body's launch of record `r` (tile, pmax: the widest bucket)
// with the buffers `a` over its table, `smem_bytes` a block
template <typename T, int MODE>
int launch(const Args<T>& a, const Launch& r, int smem_bytes, cudaStream_t s) {
  const int tile = r.own[0], pmax = r.own[1];
  if (r.blocks == 0) return 0;
  if (tile != 32 && tile != MAX_TILE) return -2;
  if (pmax < 1 || pmax > 32 || (pmax & (pmax - 1))) return -1;  // 1, 2, 4, ..., 32
  if (pmax <= 2)
    sweep_kernel<T, MODE, 2><<<r.blocks, tile, smem_bytes, s>>>(a);
  else if (pmax <= 8)
    sweep_kernel<T, MODE, 8><<<r.blocks, tile, smem_bytes, s>>>(a);
  else
    sweep_kernel<T, MODE, 32><<<r.blocks, tile, smem_bytes, s>>>(a);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ wide buckets
// Buckets wider than 32 slots (two bytes an arc: kind | slot << 2 | flag <<
// 15) run in a launch of their own, over a table of their own. One WARP owns
// one column: its lanes stride over the P slots, the column's frontier row
// lies in the warp's shared memory (the row being built beside it), the min
// over slots is a __shfl_xor_sync butterfly, and the forward relaxation
// scatters into the next row with a shared-memory atomicMin on an
// order-preserving unsigned image of the value. A minimum is exact in any
// order, and every sum is formed as the twins form it, so the results equal
// the twins' bit for bit. Tensor cores have no part in it: the work is a
// min-plus relaxation over a sparse arc set that differs in every column.
//
// What the body does about the card (it is bound by bytes: about 3 KB a hop
// and column at P = 256):
//  * Frontier rows of wide buckets lie in device memory with the SLOT
//    innermost ([H, B, P]; solver/layout.py gives the [H, P, B] view of
//    them), so the row of a column and hop is one contiguous run of P values
//    like its arc record, and a warp moves either with whole 128-byte lines.
//  * Everything a hop reads from device memory (arc record, the incoming
//    frontier row, the layer scalars) depends on no earlier hop, so the warp
//    copies it S hops ahead into a ring of S + 1 slots of its own shared
//    memory with cp.async (16 bytes a lane where the row is 16-byte aligned,
//    else a value or an arc pair a lane) and waits with cp.async.wait_group
//    only for the hop it is about to compute, then __syncwarp (a lane reads
//    what other lanes copied). The arc record is read from shared memory in
//    both passes of a hop, once from device memory.
//  * The forward frontier stays in key form from hop to hop: the pass that
//    takes the min-marginals decodes it, stores it and sets the next row to
//    the key of +inf; one __syncwarp; the scatter pass; one __syncwarp. The
//    backward hop has one __syncwarp.
//  * Shared memory is dynamic, up to the 227 KB a block may opt into: P =
//    8,192 in float64 takes one warp a block and no ring, and wider buckets
//    go to the huge body (the 13 bits of an arc's slot end there too). The
//    launch plan (solver/layout.py) picks the warps of a block from the
//    number of columns: a layout of fewer columns than 8 a SM spreads over
//    the SMs, a block of its own for every column if need be.
//  * Measured at P = 256, H = 40 (chip_smoke.py, phase 6): one hop ahead
//    (S = 1) is as good as any deeper ring, no ring costs a tenth, and what
//    is left is the hop's own chain (two passes over P / 32 slots a lane, two
//    butterflies, the scatter's atomics): about 2 us a forward hop for a warp
//    alone on its SM, so a layout of few columns takes H times that whatever
//    it moves, and 2,048 columns (16 warps an SM) take one and a half times
//    that at 60-80% of the byte bound.
// The key of a NaN is 0, below every number's, and 0 decodes to a NaN: the
// atomic min propagates a NaN as min_v and the twins' scatter-min do. The
// key orders -0.0 below +0.0, which no order of arrivals can show: a frontier
// starts from +0.0 and +inf, and a sum is -0.0 only if both its terms are, so
// no -0.0 arrives here.
template <typename T>
struct Key;

template <>
struct Key<float> {
  using U = unsigned int;
  __device__ static __forceinline__ U enc(float x) {
    const U b = __float_as_uint(x);
    if (x != x) return 0u;
    return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  }
  __device__ static __forceinline__ float dec(U k) {
    return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
  }
};

template <>
struct Key<double> {
  using U = unsigned long long;
  __device__ static __forceinline__ U enc(double x) {
    const U b = (U)__double_as_longlong(x);
    if (x != x) return 0ull;
    return (b >> 63) ? ~b : (b | 0x8000000000000000ull);
  }
  __device__ static __forceinline__ double dec(U k) {
    return __longlong_as_double((long long)((k >> 63) ? (k & 0x7fffffffffffffffull) : ~k));
  }
};

template <typename T>
__device__ __forceinline__ T warp_min(T v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = min_v(v, __shfl_xor_sync(0xffffffffu, v, d));
  return v;
}

constexpr int WIDE_SLOT_MASK = 8191;
constexpr int WIDE_MAX_WARPS = 8;
constexpr int WIDE_SCALARS = 8;  // values a ring slot keeps for the layer: lo hi din_lo din_hi alpha omega
constexpr int MAX_DYNAMIC_SMEM = 232448;  // 227 KB: the most a block may opt into

__host__ __device__ constexpr int pad16(int x) { return (x + 15) / 16 * 16; }

// the warp copies `bytes` from device to shared memory: 16 bytes a lane where
// both sides allow, else UNIT bytes a lane (an arc pair, or a value)
template <int UNIT>
__device__ __forceinline__ void warp_copy_async(unsigned char* smem, const unsigned char* gmem,
                                                int bytes, bool vec16, int lane) {
  if (vec16) {
    for (int c = lane * 16; c < bytes; c += 32 * 16) cp_async<16>(smem + c, gmem + c);
  } else {
    for (int c = lane * UNIT; c < bytes; c += 32 * UNIT) cp_async<UNIT>(smem + c, gmem + c);
  }
}

// A warp's shared memory (`warp_bytes`, sized by the plan for the widest
// bucket): two frontier rows of pad16(P values), then S + 1 ring slots of
// [arc record, pad16(4P) | incoming frontier row, pad16(P values) |
//  WIDE_SCALARS values]. solver/layout.py computes the same sizes.
template <typename T, int MODE>
__global__ void __launch_bounds__(32 * WIDE_MAX_WARPS) sweep_wide_kernel(Args<T> a, int warp_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  using K = Key<T>;
  using U = typename K::U;
  constexpr bool FORWARD = MODE == MODE_FORWARD, RUN = MODE == MODE_BACKWARD_RUN;
  constexpr int SZ = (int)sizeof(T);
  const int lane = (int)threadIdx.x & 31, warp = (int)threadIdx.x >> 5;
  const int warps = (int)blockDim.x >> 5;
  int k = 0;
  while (k + 1 < a.nr_buckets && (long long)blockIdx.x >= a.table[k + 1].first_block) ++k;
  const Bucket bk = a.table[k];
  const int P = (int)bk.P, H = (int)bk.H, B = (int)bk.B;
  const int b = (int)((long long)blockIdx.x - bk.first_block) * warps + warp;
  if (b >= B) return;  // the whole warp leaves; no block barrier below
  const T inf = inf_v<T>();
  const int S = min((int)bk.stages, MAX_STAGES), NS = S + 1;
  const int row_bytes = pad16(P * SZ), rec_bytes = pad16(4 * P);
  const int slot_bytes = rec_bytes + row_bytes + WIDE_SCALARS * SZ;
  unsigned char* const mine = smem + (size_t)warp * warp_bytes;
  // forward: cfr of this hop as keys, and the keys of the next; backward: cft
  // of hop h+1, and the row of this hop
  unsigned char* row_a = mine;
  unsigned char* row_b = mine + row_bytes;
  unsigned char* const ring = mine + 2 * row_bytes;

  const unsigned char* g_arcs = a.arcs + bk.arc_off;
  const T* g_front = RUN ? nullptr : a.frontier + bk.node_off;  // rows [H, B, P]
  T* g_out = a.out_frontier + bk.node_off;
  const bool vec_arcs = (4 * P) % 16 == 0 && ((size_t)g_arcs & 15) == 0;
  const bool vec_front = !RUN && (P * SZ) % 16 == 0 && ((size_t)g_front & 15) == 0;

  // step i works on hop h(i): forward i, backward H-1-i
  auto start_copies = [&](int i, unsigned char* slot) {
    const int h = FORWARD ? i : H - 1 - i;
    const size_t col = (size_t)h * B + b;
    warp_copy_async<4>(slot, g_arcs + col * 4 * P, 4 * P, vec_arcs, lane);
    if constexpr (!RUN) {
      // forward: cft of hop h+1 (none past the last hop); backward: cfr of hop h
      if (!FORWARD || h + 1 < H)
        warp_copy_async<SZ>(slot + rec_bytes,
                            (const unsigned char*)(g_front + (col + (FORWARD ? B : 0)) * P),
                            P * SZ, vec_front, lane);
    }
    T* sc = (T*)(slot + rec_bytes + row_bytes);
    const size_t e = (size_t)bk.row_off + col;
    const T* src = nullptr;
    if (lane == 0) src = a.lo + e;
    if (lane == 1) src = a.hi + e;
    if constexpr (!RUN) {
      if (lane == 2) src = a.din_lo + e;
      if (lane == 3) src = a.din_hi + e;
      if (lane == 4) src = a.alpha + e;
      if (lane == 5 && a.omega_arr) src = a.omega_arr + e;
    }
    if (src) cp_async<SZ>(sc + lane, src);
  };
  for (int s = 0; s < S; ++s) {
    if (s < H) start_copies(s, ring + s * slot_bytes);
    cp_commit();  // one group a step, empty or not, so the count stays even
  }
  for (int p = lane; p < P; p += 32) {
    if constexpr (FORWARD) ((U*)row_a)[p] = K::enc(inf);
    else ((T*)row_a)[p] = inf;
  }
  __syncwarp();

  int s_cur = 0, s_next = S;
  for (int i = 0; i < H; ++i) {
    const int h = FORWARD ? i : H - 1 - i;
    // refill the slot step i-1 read (every lane is past the __syncwarp that
    // ended it), then wait for step i's own group: S may pend
    if (i + S < H) start_copies(i + S, ring + s_next * slot_bytes);
    cp_commit();
    cp_wait(S);
    __syncwarp();  // the other lanes' copies of this hop are visible
    const unsigned char* slot = ring + s_cur * slot_bytes;
    s_next = s_cur;
    s_cur = s_cur + 1 == NS ? 0 : s_cur + 1;

    const uint16_t* rec = (const uint16_t*)slot;
    const T* fr = (const T*)(slot + rec_bytes);  // the incoming frontier row
    const T* sc = (const T*)(slot + rec_bytes + row_bytes);
    const size_t e = (size_t)bk.row_off + (size_t)h * B + b;
    const T lo = sc[0], hi = sc[1];
    T* fout_h = g_out + ((size_t)h * B + b) * P;
    T m0 = inf, m1 = inf, nl = lo, nh = hi, mm = T(0);

    if constexpr (FORWARD) {
      U* cur = (U*)row_a;
      U* nxt = (U*)row_b;
      if (rec[P + 1] >> 15) {  // root restart (also the hop-0 init)
        // each lane resets the slots it reads itself below: no barrier
        for (int p = lane; p < P; p += 32) cur[p] = K::enc(p == 0 ? T(0) : inf);
      }
      const bool last = h + 1 >= H;
      const U key_inf = K::enc(inf);
      for (int p = lane; p < P; p += 32) {
        const int lb = rec[p], hb = rec[P + p];
        const int lk = lb & 3, ls = (lb >> 2) & WIDE_SLOT_MASK;
        const int hk = hb & 3, hs = (hb >> 2) & WIDE_SLOT_MASK;
        // cft of the child: TOP -> 0, BOT -> inf, else cft[h+1][slot] (inf
        // past the last hop; 0 for a slot outside the bucket, as the twin)
        T tl = lk == ARC_TOP ? T(0) : inf, th = hk == ARC_TOP ? T(0) : inf;
        if (lk == ARC_INTERNAL) tl = ls < P ? (last ? inf : fr[ls]) : T(0);
        if (hk == ARC_INTERNAL) th = hs < P ? (last ? inf : fr[hs]) : T(0);
        const bool nv = (lb >> 15) != 0;
        const T f = K::dec(cur[p]);
        m0 = min_v(m0, nv ? f + lo + tl : inf);
        m1 = min_v(m1, nv ? f + hi + th : inf);
        fout_h[p] = f;
        nxt[p] = key_inf;
      }
      m0 = warp_min(m0);
      m1 = warp_min(m1);
      hop_cost_update(lo, hi, m0, m1, a.omega_arr ? sc[5] : a.omega, sc[4], sc[2], sc[3],
                      (rec[P] >> 15) != 0, nl, nh, mm);
      __syncwarp();  // the next row is all +inf before any arrival
      // relax the frontier to h+1: nxt[k] = min over valid p with an
      // internal arc into k of cfr[p] + cost of that arc
      for (int p = lane; p < P; p += 32) {
        const int lb = rec[p], hb = rec[P + p];
        if (!(lb >> 15)) continue;
        const int ls = (lb >> 2) & WIDE_SLOT_MASK, hs = (hb >> 2) & WIDE_SLOT_MASK;
        const T f = K::dec(cur[p]);
        if ((lb & 3) == ARC_INTERNAL && ls < P) atomicMin(nxt + ls, K::enc(f + nl));
        if ((hb & 3) == ARC_INTERNAL && hs < P) atomicMin(nxt + hs, K::enc(f + nh));
      }
    } else {
      const T* cur = (const T*)row_a;
      T* nxt = (T*)row_b;
      if constexpr (!RUN) {
      for (int p = lane; p < P; p += 32) {
          const int lb = rec[p], hb = rec[P + p];
          const int lk = lb & 3, ls = (lb >> 2) & WIDE_SLOT_MASK;
          const int hk = hb & 3, hs = (hb >> 2) & WIDE_SLOT_MASK;
          const T gl = ls < P ? cur[ls] : T(0), gh = hs < P ? cur[hs] : T(0);
          const T tl = lk == ARC_TOP ? T(0) : (lk == ARC_BOT ? inf : gl);
          const T th = hk == ARC_TOP ? T(0) : (hk == ARC_BOT ? inf : gh);
          const bool nv = (lb >> 15) != 0;
          const T cf = fr[p];  // cfr of this hop
          m0 = min_v(m0, nv ? cf + lo + tl : inf);
          m1 = min_v(m1, nv ? cf + hi + th : inf);
        }
        m0 = warp_min(m0);
        m1 = warp_min(m1);
        hop_cost_update(lo, hi, m0, m1, a.omega_arr ? sc[5] : a.omega, sc[4], sc[2], sc[3],
                        (rec[P] >> 15) != 0, nl, nh, mm);
      }
      for (int p = lane; p < P; p += 32) {
        const int lb = rec[p], hb = rec[P + p];
        const int lk = lb & 3, ls = (lb >> 2) & WIDE_SLOT_MASK;
        const int hk = hb & 3, hs = (hb >> 2) & WIDE_SLOT_MASK;
        const T gl = ls < P ? cur[ls] : T(0), gh = hs < P ? cur[hs] : T(0);
        const T tl = lk == ARC_TOP ? T(0) : (lk == ARC_BOT ? inf : gl);
        const T th = hk == ARC_TOP ? T(0) : (hk == ARC_BOT ? inf : gh);
        const T v = (lb >> 15) ? min_v(nl + tl, nh + th) : inf;
        nxt[p] = v;
        fout_h[p] = v;
      }
    }
    __syncwarp();  // the row is built, and the ring slot is free to refill
    unsigned char* const swap = row_a;
    row_a = row_b;
    row_b = swap;
    if constexpr (!RUN) {
      if (lane == 0) {
        a.out_lo[e] = nl;
        a.out_hi[e] = nh;
        a.out_mm[e] = mm;
      }
    }
  }
}

// as `launch`, over the table of the wide buckets: `warps` columns a block
// (one warp each), `warp_bytes` of shared memory a warp
template <typename T, int MODE>
int launch_wide(const Args<T>& a, const Launch& r, int smem_bytes, cudaStream_t s) {
  const int warps = r.own[0], warp_bytes = r.own[1];
  if (r.blocks == 0) return 0;
  if (warps < 1 || warps > WIDE_MAX_WARPS) return -2;
  if (warp_bytes < 1 || warp_bytes % 16 || smem_bytes != warps * warp_bytes ||
      smem_bytes > MAX_DYNAMIC_SMEM)
    return -1;
  static bool opted_in = false;  // above 48 KB a kernel must ask, once
  if (!opted_in) {
    const cudaError_t rc =
        cudaFuncSetAttribute(sweep_wide_kernel<T, MODE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_DYNAMIC_SMEM);
    if (rc != cudaSuccess) return (int)rc;
    opted_in = true;
  }
  sweep_wide_kernel<T, MODE><<<r.blocks, 32 * warps, smem_bytes, s>>>(a, warp_bytes);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ huge buckets
// Buckets past the wide body run a third launch, one BLOCK a column, over a
// table of their own: the buckets wider than 8,192 slots (four bytes an arc:
// kind | slot << 2 | flag << 30, bit 31 clear) and, routed there by the
// launch plan, the wide buckets from HUGE_FROM (solver/layout.py) up to
// 8,192 slots, which keep their two-byte records (kind | slot << 2 | flag <<
// 15). It replaces, as the other bodies do, _forward_kernel and
// _backward_kernel of bdd_tpu/solver/pallas_uniform.py:112, :183, and the
// XLA scans that the JAX package runs for such widths
// (bucket_forward_iteration / bucket_backward_iteration / bucket_backward_run,
// bdd_tpu/solver/uniform.py:1281, :1335, :1208). A huge bucket is not padded
// to 128 columns (layout.lane_pad): a padding column costs a block its whole
// sweep.
//
// Bound: bytes. Per (hop, column) the record (2P arc words), P frontier
// values in and P out and a few layer values; at P = 16,384 256 KB a hop and
// column in float32 and 384 KB in float64, 10.3 / 15.4 us a hop for 132
// columns at 3.35 TB/s. The block must stream its column's share of that
// (about 25 GB/s an SM) through a serial chain of hops, with two reductions
// over the whole block in each.
//
// Three forms, chosen by the plan per bucket by the bytes of its rows:
//  * the SHARED-MEMORY body (sweep_huge_kernel, LAUNCHES key "_huge"): the
//    bucket's rows live in shared memory. It takes every huge bucket whose
//    smallest block (a row of P values and a row of P slot codes) fits the
//    227 KB a block may opt into: up to 29,016 slots in float32 and 19,316
//    in float64 (layout.huge_fits). A launch takes it in one of two kernels
//    by its table's widest bucket against its threads (the record's hops):
//    the grouped body below (sweep_huge_kernel) where a thread holds more
//    than one slot, its slot loops bound by bandwidth (knapsack rows of
//    8,192 and 16,384 slots, 8 and 16 a thread); the ring form
//    (sweep_huge_ring_kernel, its own section below) where no bucket is
//    wider than the threads, one slot a thread, bound by the latency of its
//    loads (the 1,024-slot capacity rows of a generalized assignment);
//  * the CLUSTER body (sweep_huge_cluster_kernel, "_huge_cluster", its own
//    section below): wider buckets whose rows fit the shared memory of a
//    cluster of 2, 4, 8 or 16 blocks, each block a share of the row
//    (layout.cluster_fits);
//  * the L2 body (sweep_huge_l2_kernel, "_huge_l2", its own section
//    below), for what no cluster holds (and where a plan is built so): its
//    rows in device memory, served from L2, each column spread over G blocks
//    (the record's own[0]) that meet at a hop barrier of the column in
//    device memory; the forward's key rows in a scratch buffer
//    (layout.huge_scratch), relaxed by global atomicMin.
//
// Two findings of the L2 body's first form, one block a column
// (chip_smoke.py --huge-split, knapsack48 at B = 132 on an NVIDIA H100
// 80GB HBM3 at 700 W; PERF.md section 6): it spent its time on its global
// atomics and L2 gathers, not its bytes. Its forward with the relaxation
// into a row of shared memory took 1.14 / 1.62 ms instead of 1.44 / 2.04
// (float32 / float64); prefetching the next hop to L2 made either body
// slower (1.71 / 2.37 ms), so no body prefetches.
//
// Design of the shared-memory body, and what each point answers:
//  * Every random access goes to shared memory. The forward relaxation is a
//    red.shared.min on the order-preserving key (Key<T>, 64-bit in float64)
//    into one row of P keys; the backward gathers its children from the row
//    of hop h+1 in shared memory (two rows, read and built, where two fit
//    for the SM's blocks; else one row, and a barrier before it is
//    overwritten from the hop's output in L2). The forward gathers cft of
//    hop h+1 through L1 from device memory: staged in shared memory instead
//    (a ring of two rows filled a hop ahead with cp.async by every thread,
//    where two blocks an SM still fit) it was slower (chip_smoke.py
//    --huge-split, variant "staged"; PERF.md section 6). That and the L2
//    prefetch were tried one hop ahead at 4 to 16 slots a thread, where a
//    thread's grouped loads already overlap; the ring form copies whole hops
//    several ahead where a thread has one slot.
//  * No register arrays: the slot loops are runtime loops, and what a slot
//    needs after the hop's reduction is kept where only its owner reads it:
//    its code (both children, as a slot, 0 or +inf, and the node's valid
//    flag; four bytes) in a row of codes in shared memory, the forward's cfr
//    value in the hop's own output, read back from L2 by the relaxation. A
//    first design that held 16 slots a thread in registers spilled (32
//    registers and 800-940 B of stack frame in float64) and ran 1.9 / 5.7
//    ms. The arc words (half the hop's bytes) are read once, by the first
//    pass.
//  * Loads in flight: a thread takes its slots in groups of HUGE_GROUP where
//    it has that many, every device-memory load of a group issued first
//    (shared memory goes through volatile asm with 32-bit addresses, which
//    the compiler does not move loads across); a child's cost is looked up
//    only for a slot code, since most slots of a layer hold no node. The
//    layer values arrive by cp.async a hop ahead.
//  * One barrier for the min-marginals: each warp reduces its partials by
//    shuffles, writes them, and after the barrier every warp reduces the
//    warps' partials itself (no second barrier to broadcast a result).
//    Forward: that barrier and one at the hop's end. Backward: the same,
//    plus one before the row is overwritten when it has only one. Run: one
//    (two with one row).
// Measured at knapsack48 (same card, PERF.md section 6): 62-84% of the byte
// bound in the four half-sweeps and 60-62% in the run, against 32-42% and
// 54-58% for the L2 body in the same call.
// A minimum is exact in any order and every sum is formed as the twins form
// it, so the results equal the twins' bit for bit, as in the other bodies.
constexpr unsigned HUGE_SLOT_MASK = (1u << 28) - 1;
constexpr int HUGE_MAX_THREADS = 1024;
constexpr int WIDE_P = 8192;          // two-byte records up to here
constexpr int HUGE_SCALARS = 8;       // values a ring slot keeps for the layer (6 used)
constexpr int HUGE_COUNT_SMEM = 16 * (HUGE_MAX_THREADS / 32);  // the counting form's static tallies
constexpr unsigned CODE_INF = 0x7fffu;   // child code: +inf (BOT; forward, no relaxation)
constexpr unsigned CODE_ZERO = 0x7ffeu;  // child code: 0 (TOP, or a slot outside the bucket)
constexpr unsigned NODE_VALID = 0x8000u;

template <typename W>
struct Arc;

template <>
struct Arc<uint16_t> {
  static constexpr unsigned MASK = WIDE_SLOT_MASK;
  __device__ static __forceinline__ unsigned flag(unsigned w) { return w >> 15; }
};

template <>
struct Arc<uint32_t> {
  static constexpr unsigned MASK = HUGE_SLOT_MASK;
  __device__ static __forceinline__ unsigned flag(unsigned w) { return (w >> 30) & 1u; }
};

// a child's cost as a code: a slot of the bucket, 0 or +inf
__device__ __forceinline__ unsigned child_code(unsigned kind, unsigned slot, unsigned P) {
  if (kind == ARC_INTERNAL) return slot < P ? slot : CODE_ZERO;
  return kind == ARC_TOP ? CODE_ZERO : CODE_INF;
}

// Shared memory by 32-bit shared addresses: explicit ld / st / red.shared,
// so that no row access becomes a generic one and no address takes two
// registers.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
template <typename V>
__device__ __forceinline__ V ld_shared(uint32_t a);
template <>
__device__ __forceinline__ float ld_shared<float>(uint32_t a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a) : "memory");
  return v;
}
template <>
__device__ __forceinline__ double ld_shared<double>(uint32_t a) {
  double v;
  asm volatile("ld.shared.f64 %0, [%1];" : "=d"(v) : "r"(a) : "memory");
  return v;
}
template <>
__device__ __forceinline__ unsigned ld_shared<unsigned>(uint32_t a) {
  unsigned v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(a) : "memory");
  return v;
}
template <>
__device__ __forceinline__ unsigned long long ld_shared<unsigned long long>(uint32_t a) {
  unsigned long long v;
  asm volatile("ld.shared.u64 %0, [%1];" : "=l"(v) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ void st_shared(uint32_t a, float v) {
  asm volatile("st.shared.f32 [%0], %1;" ::"r"(a), "f"(v) : "memory");
}
__device__ __forceinline__ void st_shared(uint32_t a, double v) {
  asm volatile("st.shared.f64 [%0], %1;" ::"r"(a), "d"(v) : "memory");
}
__device__ __forceinline__ void st_shared(uint32_t a, unsigned v) {
  asm volatile("st.shared.u32 [%0], %1;" ::"r"(a), "r"(v) : "memory");
}
__device__ __forceinline__ void st_shared(uint32_t a, unsigned long long v) {
  asm volatile("st.shared.u64 [%0], %1;" ::"r"(a), "l"(v) : "memory");
}
__device__ __forceinline__ void red_min_shared(uint32_t a, unsigned v) {
  asm volatile("red.shared.min.u32 [%0], %1;" ::"r"(a), "r"(v) : "memory");
}
__device__ __forceinline__ void red_min_shared(uint32_t a, unsigned long long v) {
  asm volatile("red.shared.min.u64 [%0], %1;" ::"r"(a), "l"(v) : "memory");
}

// a block barrier; TIMED (the huge body's counting form): lane 0 of each
// warp adds its SM cycles from its arrival to its release to its warp's
// 64-bit sum at shared address `tally` + 16 warp, keeping its clock at
// arrival in the eight bytes after it (a store alone before the barrier:
// nothing to wait for there, and no register of the body held across it);
// it reads its clock first thing after the release. So the sums are what
// each warp lost at the barrier, the last to arrive (thread 0's warp, which
// also starts the ring slot's copies and writes the layer's outputs) and
// those that wait on it alike.
template <bool TIMED>
__device__ __forceinline__ void block_sync(uint32_t tally) {
  if constexpr (TIMED) {
    const bool lead = (threadIdx.x & 31) == 0;
    const uint32_t mine = tally + 16u * (threadIdx.x >> 5);
    if (lead) st_shared(mine + 8u, (unsigned long long)clock64());
    __syncthreads();
    if (lead) {
      const unsigned long long released = clock64();
      st_shared(mine, ld_shared<unsigned long long>(mine) + released -
                          ld_shared<unsigned long long>(mine + 8u));
    }
  } else {
    __syncthreads();
  }
}

// min of (m0, m1) over the block, in every thread, with one barrier: each
// warp reduces the warps' partials itself. `red` is [64] in shared memory,
// free again once the block has passed its next barrier. TIMED: the barrier
// is timed into `tally` (block_sync).
template <typename T, bool TIMED = false>
__device__ __forceinline__ void block_min2_once(T& m0, T& m1, T* red, uint32_t tally = 0u) {
  const int lane = (int)threadIdx.x & 31, warp = (int)threadIdx.x >> 5;
  const int warps = (int)blockDim.x >> 5;
  m0 = warp_min(m0);
  m1 = warp_min(m1);
  if (lane == 0) {
    red[warp] = m0;
    red[32 + warp] = m1;
  }
  block_sync<TIMED>(tally);
  const T inf = inf_v<T>();
  m0 = warp_min(lane < warps ? red[lane] : inf);
  m1 = warp_min(lane < warps ? red[32 + lane] : inf);
}

// a slot's arc words as one code: both children's (a slot, 0 or +inf) and
// the node's valid flag
template <typename W>
__device__ __forceinline__ unsigned slot_code(unsigned l, unsigned r, unsigned P) {
  using A = Arc<W>;
  return child_code(l & 3u, (l >> 2) & A::MASK, P) |
         (child_code(r & 3u, (r >> 2) & A::MASK, P) << 16) | (A::flag(l) ? NODE_VALID : 0u);
}

// the cost of a child by its code, from a row of the next hop's cft in
// shared memory (shared address `row`) or in device memory (`grow`); `has`:
// false past the last hop. Only a slot loads: most slots of a layer hold no
// node, and their children cost nothing to look up.
template <typename T, bool SHARED>
__device__ __forceinline__ T child_cost(unsigned c, uint32_t row, const T* grow, bool has) {
  const T inf = inf_v<T>();
  if (c == CODE_INF) return inf;
  if (c == CODE_ZERO) return T(0);
  if (!has) return inf;
  if constexpr (SHARED) return ld_shared<T>(row + c * (unsigned)sizeof(T));
  else return __ldg(grow + c);
}

// The slot loops of the huge body take a thread's slots (p = t + j *
// blockDim) one at a time (four unrolled) or in groups (p = p0 + u *
// blockDim, u < HUGE_GROUP): every device-memory load of a group is issued
// before the first of them is used (the shared-memory accesses are volatile
// asm, which the compiler does not move loads across). Measured per pass
// (chip_smoke.py --huge-split; PERF.md section 6): the forward in groups
// where a thread has HUGE_GROUP slots or more, else a slot at a time; the
// backward always in groups (with a second, one-slot form compiled beside it
// its float64 pass at knapsack48 took a fifth longer and its float32 pass a
// tenth less: the grouped loop's code moves with what else the kernel
// holds); the run a slot at a time.
constexpr int HUGE_GROUP = 4;

// The forward's first pass over this thread's slots, cft of hop h+1 read
// through L1: the slot codes into their row, cfr of the hop out, the
// thread's part of the min-marginals, its slots of the key row reset to +inf.
template <typename T, typename W, int G>
__device__ __forceinline__ void forward_pass(const W* rec, int P, uint32_t key, uint32_t codes,
                                             const T* cft_g, bool has, bool restart, T lo, T hi,
                                             T* fout, T& m0, T& m1) {
  using K = Key<T>;
  using U = typename K::U;
  const T inf = inf_v<T>();
  const U key_inf = K::enc(inf);
  const int nt = (int)blockDim.x;
#pragma unroll(G == 1 ? 4 : 1)
  for (int p0 = (int)threadIdx.x; p0 < P; p0 += G * nt) {
    unsigned l[G], r[G], c[G];
    T tl[G], th[G];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int p = p0 + u * nt;
      l[u] = p < P ? (unsigned)rec[p] : 0u;
      r[u] = p < P ? (unsigned)rec[P + p] : 0u;
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      c[u] = slot_code<W>(l[u], r[u], (unsigned)P);
      // cft of the child: TOP -> 0, BOT -> inf, else cft[h+1][slot] (inf
      // past the last hop; 0 for a slot outside the bucket, as the twin)
      tl[u] = child_cost<T, false>(c[u] & 0x7fffu, 0u, cft_g, has);
      th[u] = child_cost<T, false>(c[u] >> 16, 0u, cft_g, has);
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int p = p0 + u * nt;
      if (p < P) {
        st_shared(codes + 4u * (unsigned)p, c[u]);
        const bool nv = (c[u] & NODE_VALID) != 0;
        const uint32_t kp = key + (unsigned)p * (unsigned)sizeof(U);
        const T fv = restart ? (p == 0 ? T(0) : inf) : K::dec(ld_shared<U>(kp));
        st_shared(kp, key_inf);  // only this thread reads slot p; relaxed after the barrier
        m0 = min_v(m0, nv ? fv + lo + tl[u] : inf);
        m1 = min_v(m1, nv ? fv + hi + th[u] : inf);
        fout[p] = fv;
      }
    }
  }
}

// The forward relaxation: key[k] = min over valid p with an internal arc
// into k of cfr[p] + cost of that arc; cfr[p] read back from this hop's
// output (in L2)
template <typename T, int G>
__device__ __forceinline__ void relax_pass(int P, uint32_t key, uint32_t codes, const T* fout,
                                           T nl, T nh) {
  using K = Key<T>;
  using U = typename K::U;
  const int nt = (int)blockDim.x;
#pragma unroll(G == 1 ? 4 : 1)
  for (int p0 = (int)threadIdx.x; p0 < P; p0 += G * nt) {
    unsigned c[G];
    T fv[G];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int p = p0 + u * nt;
      c[u] = p < P ? ld_shared<unsigned>(codes + 4u * (unsigned)p) : 0u;
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const bool any = (c[u] & NODE_VALID) && ((c[u] & 0x7fffu) < CODE_ZERO ||
                                                (c[u] >> 16) < CODE_ZERO);
      fv[u] = any ? __ldcg(fout + p0 + u * nt) : T(0);
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      if (c[u] & NODE_VALID) {
        const unsigned lc = c[u] & 0x7fffu, hc = c[u] >> 16;
        if (lc < CODE_ZERO) red_min_shared(key + lc * (unsigned)sizeof(U), K::enc(fv[u] + nl));
        if (hc < CODE_ZERO) red_min_shared(key + hc * (unsigned)sizeof(U), K::enc(fv[u] + nh));
      }
    }
  }
}

// The backward's first pass: the slot codes into their row and the thread's
// part of the min-marginals, from cfr of this hop (own slots, device memory)
// and the children's cft in the row of hop h+1 (`rin`)
template <typename T, typename W, int G>
__device__ __forceinline__ void backward_pass(const W* rec, const T* cfr, int P, uint32_t codes,
                                              uint32_t rin, bool has, T lo, T hi, T& m0,
                                              T& m1) {
  const T inf = inf_v<T>();
  const int nt = (int)blockDim.x;
#pragma unroll(G == 1 ? 4 : 1)
  for (int p0 = (int)threadIdx.x; p0 < P; p0 += G * nt) {
    unsigned l[G], r[G];
    T cf[G];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int p = p0 + u * nt;
      l[u] = p < P ? (unsigned)rec[p] : 0u;
      r[u] = p < P ? (unsigned)rec[P + p] : 0u;
      cf[u] = p < P ? cfr[p] : T(0);
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int p = p0 + u * nt;
      const unsigned c = slot_code<W>(l[u], r[u], (unsigned)P);
      if (p < P) st_shared(codes + 4u * (unsigned)p, c);
      const T tl = child_cost<T, true>(c & 0x7fffu, rin, nullptr, has);
      const T th = child_cost<T, true>(c >> 16, rin, nullptr, has);
      const bool nv = p < P && (c & NODE_VALID);
      m0 = min_v(m0, nv ? cf[u] + lo + tl : inf);
      m1 = min_v(m1, nv ? cf[u] + hi + th : inf);
    }
  }
}

// cft of this hop from the new costs (nl, nh): out to device memory and,
// with two rows, into the row being built (`rout`); the run decodes the
// record here, the backward reads the codes its first pass wrote
template <typename T, typename W, bool RUN, int G>
__device__ __forceinline__ void cft_pass(const W* rec, int P, uint32_t codes, uint32_t rin,
                                         bool has, T nl, T nh, T* fout, uint32_t rout,
                                         bool two_rows) {
  const T inf = inf_v<T>();
  const int nt = (int)blockDim.x;
#pragma unroll(G == 1 ? 4 : 1)
  for (int p0 = (int)threadIdx.x; p0 < P; p0 += G * nt) {
    unsigned c[G];
    if constexpr (RUN) {
      unsigned l[G], r[G];
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const int p = p0 + u * nt;
        l[u] = p < P ? (unsigned)rec[p] : 0u;
        r[u] = p < P ? (unsigned)rec[P + p] : 0u;
      }
#pragma unroll
      for (int u = 0; u < G; ++u) c[u] = slot_code<W>(l[u], r[u], (unsigned)P);
    } else {
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const int p = p0 + u * nt;
        c[u] = p < P ? ld_shared<unsigned>(codes + 4u * (unsigned)p) : 0u;
      }
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int p = p0 + u * nt;
      const T tl = child_cost<T, true>(c[u] & 0x7fffu, rin, nullptr, has);
      const T th = child_cost<T, true>(c[u] >> 16, rin, nullptr, has);
      const T v = (c[u] & NODE_VALID) ? min_v(nl + tl, nh + th) : inf;
      if (p < P) {
        fout[p] = v;
        if (two_rows) st_shared(rout + (unsigned)p * (unsigned)sizeof(T), v);
      }
    }
  }
}

// one row: this thread's outputs back from L2 into the row, a group of
// loads in flight at a time
template <typename T>
__device__ __forceinline__ void copy_back(const T* fout, int P, uint32_t row) {
  constexpr int G = HUGE_GROUP;
  const int nt = (int)blockDim.x;
  for (int p0 = (int)threadIdx.x; p0 < P; p0 += G * nt) {
    T v[G];
#pragma unroll
    for (int u = 0; u < G; ++u) v[u] = p0 + u * nt < P ? __ldcg(fout + p0 + u * nt) : T(0);
#pragma unroll
    for (int u = 0; u < G; ++u)
      if (p0 + u * nt < P) st_shared(row + (unsigned)(p0 + u * nt) * (unsigned)sizeof(T), v[u]);
  }
}

// Dynamic shared memory of a block (solver/layout.py, huge_smem_bytes):
// [row 0 | row 1 (backward, where the table's last column is 2) | the slot
//  codes, pad16(4P) | 64 values of partials | two ring slots of HUGE_SCALARS
//  values], every row pad16(P values).
// COUNT: the counting instantiation (sweep_huge_counted_kernel), which times
// each warp at every barrier of a hop (the min-marginals' one, the one before
// a single row is overwritten, the hop's last) into its sum at shared
// address `tally` (block_sync). Without COUNT the body holds no clock read.
template <typename T, int MODE, typename W, bool COUNT>
__device__ __forceinline__ void huge_column(const Args<T>& a, const Bucket& bk,
                                            unsigned char* smem, long long b, uint32_t tally) {
  using K = Key<T>;
  using A = Arc<W>;
  constexpr bool FORWARD = MODE == MODE_FORWARD, RUN = MODE == MODE_BACKWARD_RUN;
  constexpr int SZ = (int)sizeof(T);
  constexpr int G = HUGE_GROUP;
  const int P = (int)bk.P, H = (int)bk.H;
  const long long B = bk.B;
  const int t = (int)threadIdx.x, nt = (int)blockDim.x;
  const bool grouped = FORWARD ? P >= G * nt : !RUN;
  const bool two_rows = !FORWARD && bk.stages == 2;
  const T inf = inf_v<T>();
  const int row_bytes = pad16(P * SZ);
  const uint32_t row0 = smem_addr(smem);
  const uint32_t codes = row0 + (two_rows ? 2 : 1) * row_bytes;
  T* const red = (T*)(smem + (two_rows ? 2 : 1) * row_bytes + pad16(4 * P));
  unsigned char* const ring = (unsigned char*)(red + 64);
  const int slot_bytes = HUGE_SCALARS * SZ;

  const W* const g_arcs = (const W*)(a.arcs + bk.arc_off);
  const T* const g_front = RUN ? nullptr : a.frontier + bk.node_off;  // rows [H, B, P]
  T* const g_out = a.out_frontier + bk.node_off;
  const int nscalars = RUN ? 2 : (a.omega_arr ? 6 : 5);

  // the layer values of hop h into a ring slot
  auto start_copies = [&](int h, unsigned char* slot) {
    const size_t e = (size_t)bk.row_off + (size_t)h * B + b;
    if (t < nscalars) {
      const T* src = t == 0 ? a.lo : t == 1 ? a.hi : t == 2 ? a.din_lo : t == 3 ? a.din_hi
                     : t == 4 ? a.alpha : a.omega_arr;
      cp_async<SZ>(slot + t * SZ, src + e);
    }
  };

  if constexpr (FORWARD) {
    for (int p = t; p < P; p += nt) st_shared(row0 + (unsigned)p * (unsigned)SZ, K::enc(inf));
  }
  start_copies(FORWARD ? 0 : H - 1, ring);
  cp_commit();
  cp_wait(0);
  __syncthreads();

  uint32_t rin = row0;                                 // backward: cft of hop h+1
  uint32_t rout = two_rows ? row0 + row_bytes : row0;  // the row being built
  for (int i = 0; i < H; ++i) {
    const int h = FORWARD ? i : H - 1 - i;
    unsigned char* const slot = ring + (i & 1) * slot_bytes;
    if (i + 1 < H) start_copies(FORWARD ? h + 1 : h - 1, ring + ((i + 1) & 1) * slot_bytes);
    cp_commit();
    const size_t col = (size_t)h * B + b;
    const W* rec = g_arcs + col * 2 * P;
    const unsigned w_layer = rec[P], w_root = rec[P + 1];
    const T* sc = (const T*)slot;
    const T lo = sc[0], hi = sc[1];
    T* fout = g_out + col * P;
    T nl = lo, nh = hi, mm = T(0);
    const bool has = h + 1 < H;  // cft of hop h+1 (none past the last hop)

    if constexpr (FORWARD) {
      const bool restart = A::flag(w_root) != 0;  // also the hop-0 init
      const T* cft_g = g_front + (col + (size_t)B) * P;  // cft of hop h+1
      T m0 = inf, m1 = inf;
      if (grouped)
        forward_pass<T, W, G>(rec, P, row0, codes, cft_g, has, restart, lo, hi, fout, m0, m1);
      else
        forward_pass<T, W, 1>(rec, P, row0, codes, cft_g, has, restart, lo, hi, fout, m0, m1);
      // also: every reset and every read of cft is done
      block_min2_once<T, COUNT>(m0, m1, red, tally);
      hop_cost_update(lo, hi, m0, m1, a.omega_arr ? sc[5] : a.omega, sc[4], sc[2], sc[3],
                      A::flag(w_layer) != 0, nl, nh, mm);
      if (grouped)
        relax_pass<T, G>(P, row0, codes, fout, nl, nh);
      else
        relax_pass<T, 1>(P, row0, codes, fout, nl, nh);
    } else {
      if constexpr (!RUN) {
        const T* cfr = g_front + col * P;  // cfr of this hop, own slots
        T m0 = inf, m1 = inf;
        if (grouped)
          backward_pass<T, W, G>(rec, cfr, P, codes, rin, has, lo, hi, m0, m1);
        else
          backward_pass<T, W, 1>(rec, cfr, P, codes, rin, has, lo, hi, m0, m1);
        block_min2_once<T, COUNT>(m0, m1, red, tally);
        hop_cost_update(lo, hi, m0, m1, a.omega_arr ? sc[5] : a.omega, sc[4], sc[2], sc[3],
                        A::flag(w_layer) != 0, nl, nh, mm);
      }
      if (grouped)
        cft_pass<T, W, RUN, G>(rec, P, codes, rin, has, nl, nh, fout, rout, two_rows);
      else
        cft_pass<T, W, RUN, 1>(rec, P, codes, rin, has, nl, nh, fout, rout, two_rows);
      if (!two_rows) {
        // every gather from the row is done before it is overwritten
        block_sync<COUNT>(tally);
        copy_back(fout, P, rout);
      }
    }
    if constexpr (!RUN) {
      if (t == 0) {
        const size_t e = (size_t)bk.row_off + col;
        a.out_lo[e] = nl;
        a.out_hi[e] = nh;
        a.out_mm[e] = mm;
      }
    }
    cp_wait(0);                // the next hop's ring slot has landed
    block_sync<COUNT>(tally);  // the row is built, and this hop's ring slot is free
    if (two_rows) {
      const uint32_t swap = rin;
      rin = rout;
      rout = swap;
    }
  }
}

// a block of the huge body: its bucket by the table, its body by the
// bucket's width (`launch_huge` admits only a table whose slots fit a code;
// the plan sends no other bucket)
template <typename T, int MODE, bool COUNT>
__device__ __forceinline__ void huge_block(const Args<T>& a, unsigned char* smem,
                                           uint32_t tally) {
  int k = 0;
  while (k + 1 < a.nr_buckets && (long long)blockIdx.x >= a.table[k + 1].first_block) ++k;
  const Bucket bk = a.table[k];
  const long long b = (long long)blockIdx.x - bk.first_block;  // the column
  if (bk.P <= WIDE_P)
    huge_column<T, MODE, uint16_t, COUNT>(a, bk, smem, b, tally);
  else
    huge_column<T, MODE, uint32_t, COUNT>(a, bk, smem, b, tally);
}

template <typename T, int MODE>
__global__ void __launch_bounds__(HUGE_MAX_THREADS, 1) sweep_huge_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  huge_block<T, MODE, false>(a, smem, 0u);
}

// the counting form: it adds its warps' summed wait at the hop barriers and
// its warps' SM cycles from the block's start to its end (the block's cycles
// times its warps) to acc[0] and acc[1], thread 0 by one atomic each (the
// start's clock subtracted at the start, the end's added at the end). Each
// warp keeps its sum and its clock at a barrier's arrival in static shared
// memory, whose address is a constant: in registers (or in the dynamic
// layout, whose addresses are not) thread 0's alone slowed the backward by up
// to a fifth (PERF.md section 6). The same launch bounds as the body's own,
// so the compiler holds it to the same registers (64 a thread).
template <typename T, int MODE>
__global__ void __launch_bounds__(HUGE_MAX_THREADS, 1)
    sweep_huge_counted_kernel(Args<T> a, unsigned long long* acc) {
  extern __shared__ __align__(16) unsigned char smem[];
  // a warp's: the sum; a clock at arrival
  __shared__ unsigned long long tally[HUGE_COUNT_SMEM / 8];
  const unsigned long long warps = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) tally[2 * (threadIdx.x >> 5)] = 0ull;
  if (threadIdx.x == 0) atomicAdd(acc + 1, 0ull - warps * (unsigned long long)clock64());
  huge_block<T, MODE, true>(a, smem, smem_addr(tally));
  __syncthreads();  // every warp's sum is in
  if (threadIdx.x == 0) {
    const unsigned long long end = clock64();
    unsigned long long wait = 0ull;
    for (unsigned w = 0; w < warps; ++w) wait += tally[2 * w];
    atomicAdd(acc, wait);
    atomicAdd(acc + 1, warps * end);
  }
}

// ------------------------------------------- huge buckets: the ring form
// A launch whose every huge bucket is no wider than a block's threads (the
// widest bucket no wider than the threads, the record's hops: the 1,024-slot
// capacity rows of a generalized assignment at 1,024 threads) takes the RING
// form (sweep_huge_ring_kernel, LAUNCHES key "_huge" too) in place of the
// grouped body above. Thread t owns slot t; threads past P take part in the
// barriers only. Such buckets keep two-byte records (P <= 1,024 < WIDE_P).
//
// What it answers: at one slot a thread the grouped body's hop is a chain of
// dependent device-memory loads, not bytes (the slot's arc words and the
// layer's flag words; then the forward's cft of hop h+1 by the child's slot,
// the backward's cfr of its slot; the forward relaxation's cfr read back
// from L2): 2.47 / 3.53 us a hop forward / backward over 900 hops of 1,024
// slots, 5.1% / 3.6% of the byte bound, the warps 12.75% of their cycles at
// the barriers (PERF.md sections 5 and 6). Every one of those inputs is a
// launch input whose address is known at entry, so this form copies them
// all into a ring of S + 1 stages in shared memory, S = hops (the plan's
// HUGE_RING_HOPS) ahead of the hop that reads them. A stage holds one hop of
// the column: its arc record (2P two-byte words), its frontier row (forward:
// cft of hop h+1, the gathers' source; backward: cfr of hop h, the slots'
// own; the run none) and the layer's values. The copies are cp.async over the
// block's threads, one copy a thread and row at most (P <= threads): 16 bytes
// where every hop's row is 16-byte aligned, else 4 (a record) or a value's
// (a row); the record's from thread 0 on, the row's from thread nt / 2 on,
// the layer values by the last threads. At the end of
// hop i a thread waits for its own copies of hop i + 1 (cp.async.wait_group
// S - 1) before the hop's last barrier, which makes every thread's copies
// visible and frees the stage of hop i, into which hop i + 1 starts the
// copies of hop i + 1 + S. Nothing the launch writes is read ahead. What is
// left on a hop's path: shared-memory loads, registers, shuffles and the
// block barriers (forward: the min-marginals' and the hop's last; backward:
// the same, on two rows, which P <= 1,024 always has room for; run: one).
// One slot a thread also keeps in registers what the grouped body keeps
// elsewhere: the slot's code (no row of codes), the forward's cfr for its
// relaxation (no read back from L2), the children's costs for the
// backward's cft (no second gather): no grouped loop, no register arrays.
// The grouped body keeps its source: the two forms share only helpers, since
// code compiled beside the grouped loop moved its schedule by -10% to +20%
// (chip_smoke.py --huge-split; PERF.md section 6).
constexpr int HUGE_RING_MAX = 8;  // the deepest ring: cp_wait's groups in flight

// The ring form's dynamic shared memory (solver/layout.py, huge_smem_bytes
// with `ring` hops S): [the forward's row of keys, or the backward's and the
// run's two rows of cft, pad16(P values) each | 64 values of partials | S + 1
// stages of (the arc record, pad16(4P) | the frontier row, pad16(P values) |
// HUGE_SCALARS values)]; the run lays its stages out as the backward does
// and leaves their rows unused.
struct RingLayout {
  int row;      // bytes of a row of P values
  int red;      // offset of the partials
  int ring;     // offset of the first stage
  int front;    // offset of the frontier row in a stage
  int scalars;  // offset of the layer values in a stage
  int stage;    // bytes of a stage
  int total;
  __host__ __device__ RingLayout(int P, int sz, int hops, bool forward)
      : row(pad16(P * sz)),
        red((forward ? 1 : 2) * row),
        ring(red + 64 * sz),
        front(pad16(4 * P)),
        scalars(front + row),
        stage(scalars + HUGE_SCALARS * sz),
        total(ring + (hops + 1) * stage) {}
};

// one column of the ring form; COUNT times every warp at each barrier of a
// hop into its sum at shared address `tally`, as huge_column does
template <typename T, int MODE, bool COUNT>
__device__ __forceinline__ void huge_ring_column(const Args<T>& a, const Bucket& bk,
                                                 unsigned char* smem, long long b, int hops,
                                                 uint32_t tally) {
  using K = Key<T>;
  using U = typename K::U;
  using A = Arc<uint16_t>;
  constexpr bool FORWARD = MODE == MODE_FORWARD, RUN = MODE == MODE_BACKWARD_RUN;
  constexpr int SZ = (int)sizeof(T);
  const int P = (int)bk.P, H = (int)bk.H;
  const long long B = bk.B;
  const int t = (int)threadIdx.x, nt = (int)blockDim.x;
  const bool mine = t < P;  // the thread's slot is one of the bucket's
  const T inf = inf_v<T>();
  const RingLayout L(P, SZ, hops, FORWARD);
  const uint32_t row0 = smem_addr(smem);
  T* const red = (T*)(smem + L.red);
  unsigned char* const ring = smem + L.ring;
  const long long first = FORWARD ? b : (long long)(H - 1) * B + b;  // the first hop's column
  const long long step = FORWARD ? B : -B;                           // from one hop's to the next

  // This thread's share of a stage's copies, the same at every hop: with at
  // most as many slots as threads, one chunk of the record (thread t: chunk
  // t) and one of the row (thread t - nt / 2, mod nt), of 16 bytes where every
  // hop's source is 16-byte aligned (the bucket's rows start so and are a
  // multiple of 16 bytes long), else of 4 (a record) or SZ bytes (a row); a
  // layer value by each of the last threads. Sources run along, one hop a
  // step, as the stages are filled in hop order.
  const uint8_t* rec_src = a.arcs + bk.arc_off + first * 4 * P;
  const bool rec16 = !(((unsigned)(uintptr_t)(a.arcs + bk.arc_off) | 4u * (unsigned)P) & 15u);
  const int rec_c = t * (rec16 ? 16 : 4) < 4 * P ? t * (rec16 ? 16 : 4) : -1;
  const uint8_t* row_src = nullptr;
  bool row16 = false;
  int row_c = -1;
  if constexpr (!RUN) {  // forward: cft of hop h+1; backward: cfr of hop h
    const T* g_front = a.frontier + bk.node_off;
    row_src = (const uint8_t*)(g_front + (first + (FORWARD ? B : 0)) * P);
    row16 = !(((unsigned)(uintptr_t)g_front | (unsigned)(P * SZ)) & 15u);
    const int k = t < nt / 2 ? t + nt - nt / 2 : t - nt / 2;
    row_c = k * (row16 ? 16 : SZ) < P * SZ ? k * (row16 ? 16 : SZ) : -1;
  }
  const int s = nt - 1 - t;  // the layer value this thread copies, where below the count
  const T* sc_src = nullptr;
  if (s < (RUN ? 2 : (a.omega_arr ? 6 : 5)))
    sc_src = (s == 0 ? a.lo : s == 1 ? a.hi : s == 2 ? a.din_lo : s == 3 ? a.din_hi
              : s == 4 ? a.alpha : a.omega_arr) + bk.row_off + first;

  // the inputs of the i-th hop into the stage at `st`, one group of copies
  // (empty past the last hop)
  auto fill = [&](int i, unsigned char* st) {
    if (i < H) {
      if (rec_c >= 0) {
        if (rec16) cp_async<16>(st + rec_c, rec_src + rec_c);
        else cp_async<4>(st + rec_c, rec_src + rec_c);
      }
      rec_src += step * 4 * P;
      if constexpr (!RUN) {
        if (row_c >= 0 && (!FORWARD || i + 1 < H)) {
          if (row16) cp_async<16>(st + L.front + row_c, row_src + row_c);
          else cp_async<SZ>(st + L.front + row_c, row_src + row_c);
        }
        row_src += step * P * SZ;
      }
      if (sc_src) {
        cp_async<SZ>(st + L.scalars + s * SZ, sc_src);
        sc_src += step;
      }
    }
    cp_commit();
  };

  if constexpr (FORWARD) {
    if (mine) st_shared(row0 + (unsigned)t * (unsigned)SZ, K::enc(inf));
  }
  for (int i = 0; i < hops; ++i) fill(i, ring + i * L.stage);
  cp_wait(hops - 1);
  __syncthreads();

  T* out = a.out_frontier + bk.node_off + first * P + t;  // this thread's slot of hop h's row
  size_t e = (size_t)(bk.row_off + first);                 // hop h's layer outputs
  uint32_t rin = row0;                                     // backward, run: cft of hop h+1
  uint32_t rout = row0 + L.row;                            // the row being built
  int cur = 0;                                             // the stage of hop i
  for (int i = 0; i < H; ++i) {
    // the stage the last hop's barrier freed takes hop i + hops
    fill(i + hops, ring + (cur == 0 ? hops : cur - 1) * L.stage);
    const unsigned char* const st = ring + cur * L.stage;
    const uint16_t* const rec = (const uint16_t*)st;
    const T* const sc = (const T*)(st + L.scalars);
    const uint32_t frow = smem_addr(st + L.front);
    const T lo = sc[0], hi = sc[1];
    const unsigned w_layer = rec[P], w_root = rec[P + 1];
    const bool has = FORWARD ? i + 1 < H : i > 0;  // cft of hop h+1 (none past the last hop)
    const unsigned c = mine ? slot_code<uint16_t>(rec[t], rec[P + t], (unsigned)P) : 0u;
    const bool nv = (c & NODE_VALID) != 0;
    T nl = lo, nh = hi, mm = T(0);

    if constexpr (FORWARD) {
      T m0 = inf, m1 = inf, fv = inf;
      if (mine) {
        const uint32_t kp = row0 + (unsigned)t * (unsigned)SZ;
        fv = A::flag(w_root) ? (t == 0 ? T(0) : inf) : K::dec(ld_shared<U>(kp));
        st_shared(kp, K::enc(inf));  // only this thread reads slot t; relaxed after the barrier
        const T tl = child_cost<T, true>(c & 0x7fffu, frow, nullptr, has);
        const T th = child_cost<T, true>(c >> 16, frow, nullptr, has);
        m0 = nv ? fv + lo + tl : inf;
        m1 = nv ? fv + hi + th : inf;
        *out = fv;
      }
      block_min2_once<T, COUNT>(m0, m1, red, tally);
      hop_cost_update(lo, hi, m0, m1, a.omega_arr ? sc[5] : a.omega, sc[4], sc[2], sc[3],
                      A::flag(w_layer) != 0, nl, nh, mm);
      if (nv) {
        const unsigned lc = c & 0x7fffu, hc = c >> 16;
        if (lc < CODE_ZERO) red_min_shared(row0 + lc * (unsigned)sizeof(U), K::enc(fv + nl));
        if (hc < CODE_ZERO) red_min_shared(row0 + hc * (unsigned)sizeof(U), K::enc(fv + nh));
      }
    } else {
      T tl = inf, th = inf;
      if (mine) {
        tl = child_cost<T, true>(c & 0x7fffu, rin, nullptr, has);
        th = child_cost<T, true>(c >> 16, rin, nullptr, has);
      }
      if constexpr (!RUN) {
        T m0 = inf, m1 = inf;
        if (nv) {
          const T cf = ld_shared<T>(frow + (unsigned)t * (unsigned)SZ);  // cfr of the slot
          m0 = cf + lo + tl;
          m1 = cf + hi + th;
        }
        block_min2_once<T, COUNT>(m0, m1, red, tally);
        hop_cost_update(lo, hi, m0, m1, a.omega_arr ? sc[5] : a.omega, sc[4], sc[2], sc[3],
                        A::flag(w_layer) != 0, nl, nh, mm);
      }
      if (mine) {
        const T v = nv ? min_v(nl + tl, nh + th) : inf;
        *out = v;
        st_shared(rout + (unsigned)t * (unsigned)SZ, v);
      }
    }
    if constexpr (!RUN) {
      if (t == 0) {
        a.out_lo[e] = nl;
        a.out_hi[e] = nh;
        a.out_mm[e] = mm;
      }
    }
    out += step * P;
    e += step;
    cp_wait(hops - 1);         // this thread's copies of hop i + 1 have landed
    block_sync<COUNT>(tally);  // every thread's; the row is built; stage `cur` is free
    if constexpr (!FORWARD) {
      const uint32_t swap = rin;
      rin = rout;
      rout = swap;
    }
    cur = cur == hops ? 0 : cur + 1;
  }
}

// a block of the ring form: its bucket by the table
template <typename T, int MODE, bool COUNT>
__device__ __forceinline__ void huge_ring_block(const Args<T>& a, unsigned char* smem, int hops,
                                                uint32_t tally) {
  int k = 0;
  while (k + 1 < a.nr_buckets && (long long)blockIdx.x >= a.table[k + 1].first_block) ++k;
  const Bucket bk = a.table[k];
  huge_ring_column<T, MODE, COUNT>(a, bk, smem, (long long)blockIdx.x - bk.first_block, hops,
                                   tally);
}

template <typename T, int MODE>
__global__ void __launch_bounds__(HUGE_MAX_THREADS, 1) sweep_huge_ring_kernel(Args<T> a,
                                                                               int hops) {
  extern __shared__ __align__(16) unsigned char smem[];
  huge_ring_block<T, MODE, false>(a, smem, hops, 0u);
}

// its counting form, as sweep_huge_counted_kernel: every warp's wait at the
// hop barriers and the warps' SM cycles into acc[0] and acc[1]
template <typename T, int MODE>
__global__ void __launch_bounds__(HUGE_MAX_THREADS, 1)
    sweep_huge_ring_counted_kernel(Args<T> a, int hops, unsigned long long* acc) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long tally[HUGE_COUNT_SMEM / 8];
  const unsigned long long warps = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) tally[2 * (threadIdx.x >> 5)] = 0ull;
  if (threadIdx.x == 0) atomicAdd(acc + 1, 0ull - warps * (unsigned long long)clock64());
  huge_ring_block<T, MODE, true>(a, smem, hops, smem_addr(tally));
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned long long end = clock64();
    unsigned long long wait = 0ull;
    for (unsigned w = 0; w < warps; ++w) wait += tally[2 * w];
    atomicAdd(acc, wait);
    atomicAdd(acc + 1, warps * end);
  }
}

// the huge body's kernel (RING: its ring form), or with COUNT its counting form
template <typename T, int MODE, bool COUNT, bool RING>
auto huge_kernel() {
  if constexpr (RING && COUNT) return sweep_huge_ring_counted_kernel<T, MODE>;
  else if constexpr (RING) return sweep_huge_ring_kernel<T, MODE>;
  else if constexpr (COUNT) return sweep_huge_counted_kernel<T, MODE>;
  else return sweep_huge_kernel<T, MODE>;
}

// the dynamic shared memory a block of the huge body (COUNT: of its counting
// form, whose static tallies count against a block's) may take
template <bool COUNT>
constexpr int huge_max_smem() {
  return MAX_DYNAMIC_SMEM - (COUNT ? HUGE_COUNT_SMEM : 0);
}

// above 48 KB a kernel must ask for its shared memory, once
template <typename T, int MODE, bool COUNT, bool RING>
int huge_opt_in() {
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t rc = cudaFuncSetAttribute(
        huge_kernel<T, MODE, COUNT, RING>(), cudaFuncAttributeMaxDynamicSharedMemorySize,
        huge_max_smem<COUNT>());
    if (rc != cudaSuccess) return (int)rc;
    opted_in = true;
  }
  return 0;
}

// the blocks of `threads` threads and `smem_bytes` of dynamic shared memory
// of the huge body (COUNT: of its counting form; RING: of its ring form) an
// SM holds at once, the least over its three entries
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *blocks; 0 where a
// block may not take `smem_bytes`
template <typename T, bool COUNT, bool RING>
int huge_occupancy(int threads, int smem_bytes, int* blocks) {
  *blocks = 0;
  if (smem_bytes > huge_max_smem<COUNT>()) return 0;
  int rc = huge_opt_in<T, MODE_FORWARD, COUNT, RING>();
  if (rc == 0) rc = huge_opt_in<T, MODE_BACKWARD, COUNT, RING>();
  if (rc == 0) rc = huge_opt_in<T, MODE_BACKWARD_RUN, COUNT, RING>();
  int n[3] = {0, 0, 0};
  if (rc == 0)
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n[0], huge_kernel<T, MODE_FORWARD, COUNT, RING>(), threads, smem_bytes);
  if (rc == 0)
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n[1], huge_kernel<T, MODE_BACKWARD, COUNT, RING>(), threads, smem_bytes);
  if (rc == 0)
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n[2], huge_kernel<T, MODE_BACKWARD_RUN, COUNT, RING>(), threads, smem_bytes);
  *blocks = n[0] < n[1] ? (n[0] < n[2] ? n[0] : n[2]) : (n[1] < n[2] ? n[1] : n[2]);
  return rc;
}

// the same, of the grouped body (hops 0) or of the ring form at `hops`
template <typename T, bool COUNT>
int huge_occupancy(int threads, int smem_bytes, int hops, int* blocks) {
  return hops ? huge_occupancy<T, COUNT, true>(threads, smem_bytes, blocks)
              : huge_occupancy<T, COUNT, false>(threads, smem_bytes, blocks);
}

// as `launch`, over the table of the shared-memory huge body: one block of
// `threads` threads a column, `pmax` the widest bucket, `smem_bytes` of
// dynamic shared memory a block; `hops` 0: the grouped body, 1 to
// HUGE_RING_MAX: the ring form at that depth (every bucket no wider than the
// threads, `smem_bytes` at least its layout's). COUNT: the counting form,
// into the pair `acc` (the blocks' barrier wait, their cycles).
template <typename T, int MODE, bool COUNT>
int launch_huge(const Args<T>& a, const Launch& r, int smem_bytes, cudaStream_t s) {
  const int threads = r.threads, pmax = r.own[0], hops = r.own[1];
  unsigned long long* const acc = r.acc;
  if (r.blocks == 0) return 0;
  if (COUNT && acc == nullptr) return -1;
  if (threads < 32 || threads > HUGE_MAX_THREADS || threads % 32 || pmax >= (int)CODE_ZERO)
    return -2;
  if (hops < 0 || hops > HUGE_RING_MAX || (hops && pmax > threads)) return -2;
  if (smem_bytes < 1 || smem_bytes > huge_max_smem<COUNT>()) return -1;
  if (hops && smem_bytes < RingLayout(pmax, (int)sizeof(T), hops, MODE == MODE_FORWARD).total)
    return -1;
  const int rc = hops ? huge_opt_in<T, MODE, COUNT, true>() : huge_opt_in<T, MODE, COUNT, false>();
  if (rc != 0) return rc;
  if (hops) {
    if constexpr (COUNT)
      sweep_huge_ring_counted_kernel<T, MODE><<<r.blocks, threads, smem_bytes, s>>>(a, hops, acc);
    else
      sweep_huge_ring_kernel<T, MODE><<<r.blocks, threads, smem_bytes, s>>>(a, hops);
  } else if constexpr (COUNT) {
    sweep_huge_counted_kernel<T, MODE><<<r.blocks, threads, smem_bytes, s>>>(a, acc);
  } else {
    sweep_huge_kernel<T, MODE><<<r.blocks, threads, smem_bytes, s>>>(a);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------- huge buckets: the cluster body
// Rows past a block's shared memory (layout.route: "huge_cluster", from
// 29,017 slots in float32 and 19,317 in float64 up to what a cluster of 16
// holds: 309,312 / 231,552 slots) run a fifth launch: a CLUSTER of C blocks
// (2, 4, 8 or 16; thread block clusters of sm_90, 16 a non-portable size)
// a column. Block r of the cluster keeps slots [r S, (r + 1) S), S =
// ceil(P / C), of the column's rows in its shared memory, with their slot
// codes; every access to a slot another block keeps goes to that block's
// shared memory through distributed shared memory (mapa + ld / st / red
// .shared::cluster). It replaces, for these widths, what the L2 body did
// with global atomics and L2 gathers (chip_smoke.py --huge-split; PERF.md
// section 6), and keeps what the huge body does well: runtime slot loops with
// no register arrays, device loads issued HUGE_GROUP at a time, the layer
// values copied by cp.async a hop ahead, the forward's cft of hop h+1
// gathered through L1.
//
// Per hop:
//  * forward: the first pass over the block's slots (codes into their row,
//    cfr out, its key reset to +inf, the min-marginals' partials); the
//    min-marginals reduced over the block (one __syncthreads) and then over
//    the cluster: each block stores its pair into every block's row of pairs
//    and one cluster barrier ends it (it also makes every reset of the key
//    rows visible); the cost update, alike in every block; the relaxation, a
//    min on the order-preserving key (Key<T>) into the block that keeps the
//    child (cl_relax: red.shared::cluster.min in float32; in float64
//    red.shared.min into the block's own row and compare-and-swap into a
//    peer's); a cluster barrier ends the hop (every arrival in, before the
//    next hop reads its row). Two cluster barriers.
//  * backward: the first pass gathers each child's cft of hop h+1 from the
//    block that keeps it; the same reduction; the cft pass gathers again
//    and builds the block's slots of the new row. Two rows (read and built)
//    where they fit for the blocks an SM holds: two cluster barriers a hop;
//    else one row, and a third barrier before it is overwritten.
//  * run: no reduction: one cluster barrier (two with one row).
// A cluster barrier (barrier.cluster.arrive.release / wait.acquire) costs
// more than __syncthreads; at H = 48 a forward half-sweep has 96 of them.
// The first one is split: a block arrives once its key row is reset and
// waits only before its first access to a peer, so that no block reaches a
// peer that has not started. Every hop ends with a cluster barrier, so no
// block leaves while a peer may still read or write its shared memory.
//
// Slot codes (ClCode<W>) hold both children of a slot (a slot, ZERO for 0,
// INF for +inf) or NONE for a slot that holds no node (its children are
// never looked at, and cost no load). Two widths, one a launch, by the
// table's widest bucket: four bytes (two 16-bit children) where every slot
// is below CL_MAX_P, the form of the rows of 32,768 slots; eight bytes (two
// 32-bit children) past that.
// A child's block and its place there come from its slot by a multiply
// (Share::block). magic = ceil(2^32 / S) (S >= 2: a cluster bucket is wider
// than WIDE_P and C <= 16, so S > 512), magic * S = 2^32 + e with 0 <= e <
// S, so slot * magic / 2^32 = slot / S + slot * e / (S 2^32), and __umulhi
// takes the floor of that. Four-byte codes: slots and S below 2^16, so
// slot * e < 2^32 and the excess is below 1 / S, too little to carry
// slot / S past the next integer: the floor is slot / S. Eight-byte codes:
// slots below 2^28 (the record's slot field), the excess below slot / 2^32
// < 1, so the floor is slot / S or one more, and one multiply and compare
// takes the one back: exact for every slot the record holds.
// Ragged rows: P need not be a multiple of C; the last blocks hold fewer
// slots (or none) and take part in every barrier. A child slot outside the
// bucket costs 0, and BOT +inf, as in the twins and the L2 body.
// Bound: bytes, as the other huge forms; a block moves its share of the
// column's record, rows and layer values.
constexpr int CLUSTER_MAX = 16;  // cluster sizes 2, 4, 8 (portable) and 16 (non-portable)

template <typename W>
struct ClCode;
template <>
struct ClCode<unsigned> {  // two 16-bit children
  static constexpr unsigned INF = 0xffffu;   // child code: +inf (BOT)
  static constexpr unsigned ZERO = 0xfffeu;  // child code: 0 (TOP, or a slot outside the bucket)
  static constexpr unsigned NONE = 0xfffdu;  // code of a slot that holds no node
  __device__ static __forceinline__ unsigned lo(unsigned c) { return c & 0xffffu; }
  __device__ static __forceinline__ unsigned hi(unsigned c) { return c >> 16; }
  __device__ static __forceinline__ unsigned pack(unsigned l, unsigned r) { return l | (r << 16); }
};
template <>
struct ClCode<unsigned long long> {  // two 32-bit children
  static constexpr unsigned INF = 0xffffffffu;
  static constexpr unsigned ZERO = 0xfffffffeu;
  static constexpr unsigned NONE = 0xfffffffdu;
  __device__ static __forceinline__ unsigned lo(unsigned long long c) { return (unsigned)c; }
  __device__ static __forceinline__ unsigned hi(unsigned long long c) {
    return (unsigned)(c >> 32);
  }
  __device__ static __forceinline__ unsigned long long pack(unsigned l, unsigned r) {
    return (unsigned long long)l | ((unsigned long long)r << 32);
  }
};
constexpr int CL_MAX_P = (int)ClCode<unsigned>::NONE;  // four-byte codes hold slots below this

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned cluster_blocks() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}
// the address of shared address `a` (this block's) in block `rank`'s shared memory
__device__ __forceinline__ uint32_t cluster_map(uint32_t a, unsigned rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}
template <typename V>
__device__ __forceinline__ V ld_cluster(uint32_t a);
template <>
__device__ __forceinline__ float ld_cluster<float>(uint32_t a) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(a) : "memory");
  return v;
}
template <>
__device__ __forceinline__ double ld_cluster<double>(uint32_t a) {
  double v;
  asm volatile("ld.shared::cluster.f64 %0, [%1];" : "=d"(v) : "r"(a) : "memory");
  return v;
}
template <>
__device__ __forceinline__ unsigned long long ld_cluster<unsigned long long>(uint32_t a) {
  unsigned long long v;
  asm volatile("ld.shared::cluster.u64 %0, [%1];" : "=l"(v) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ void st_cluster(uint32_t a, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(a), "f"(v) : "memory");
}
__device__ __forceinline__ void st_cluster(uint32_t a, double v) {
  asm volatile("st.shared::cluster.f64 [%0], %1;" ::"r"(a), "d"(v) : "memory");
}
__device__ __forceinline__ void red_min_cluster(uint32_t a, unsigned v) {
  asm volatile("red.shared::cluster.min.u32 [%0], %1;" ::"r"(a), "r"(v) : "memory");
}
// The 64-bit min (float64 keys) into a peer's row by compare-and-swap: red
// / atom .shared::cluster.min.u64 lost arrivals on the card when blocks of a
// cluster relaxed into one row at once (a NaN's key missing from a minimum
// in the card tests on an NVIDIA H100; PERF.md section 6), the CAS loop
// never did. A thread that cannot lower the value stores nothing. Keys of
// the block's own slots take red.shared.min.u64 through its own window
// (cl_relax), as in the huge body.
__device__ __forceinline__ void red_min_cluster(uint32_t a, unsigned long long v) {
  unsigned long long old = ld_cluster<unsigned long long>(a);
  while (old > v) {
    const unsigned long long seen = old;
    asm volatile("atom.shared::cluster.cas.b64 %0, [%1], %2, %3;"
                 : "=l"(old) : "r"(a), "l"(seen), "l"(v) : "memory");
    if (old == seen) return;
  }
}

// where a slot lies in the cluster: block slot / S, place slot % S (W: the
// launch's slot code, whose width bounds the slots; see above)
template <typename W>
struct Share {
  unsigned S, magic;  // magic = ceil(2^32 / S)
  __device__ __forceinline__ unsigned block(unsigned slot) const {
    const unsigned q = __umulhi(slot, magic);
    if constexpr (sizeof(W) == 8) return q * S > slot ? q - 1u : q;
    return q;
  }
  __device__ __forceinline__ uint32_t at(uint32_t row, unsigned slot, unsigned size) const {
    const unsigned q = block(slot);
    return cluster_map(row + (slot - q * S) * size, q);
  }
};

template <typename W>
__device__ __forceinline__ unsigned cl_child(unsigned w, unsigned P) {
  using CC = ClCode<W>;
  const unsigned kind = w & 3u, slot = (w >> 2) & HUGE_SLOT_MASK;
  if (kind == ARC_INTERNAL) return slot < P ? slot : CC::ZERO;
  return kind == ARC_TOP ? CC::ZERO : CC::INF;
}
template <typename W>
__device__ __forceinline__ W cl_code(unsigned l, unsigned r, unsigned P) {
  using CC = ClCode<W>;
  return Arc<uint32_t>::flag(l) ? CC::pack(cl_child<W>(l, P), cl_child<W>(r, P)) : W(CC::NONE);
}
// the cost of child `c` of a node from the cluster's row at shared address
// `row` (`has`: false past the last hop)
template <typename T, typename W>
__device__ __forceinline__ T cl_cost(unsigned c, uint32_t row, const Share<W>& sh, bool has) {
  if (c == ClCode<W>::INF) return inf_v<T>();
  if (c == ClCode<W>::ZERO) return T(0);
  if (!has) return inf_v<T>();
  return ld_cluster<T>(sh.at(row, c, (unsigned)sizeof(T)));
}

// the same from a row in device memory (`g`: cft of hop h+1), through L1
template <typename T, typename W>
__device__ __forceinline__ T cl_cost_g(unsigned c, const T* g, bool has) {
  if (c == ClCode<W>::INF) return inf_v<T>();
  if (c == ClCode<W>::ZERO) return T(0);
  if (!has) return inf_v<T>();
  return __ldg(g + c);
}

// The forward's first pass over the block's slots [base, base + n): cft of
// hop h+1 read through L1, the slot codes into their row, cfr of the hop
// out, the partials of the min-marginals, the block's keys reset to +inf.
template <typename T, typename W, int G>
__device__ __forceinline__ void cl_forward_pass(const uint32_t* rec, int P, int base, int n,
                                                uint32_t key, uint32_t codes, const T* cft_g,
                                                bool has, bool restart, T lo, T hi, T* fout,
                                                T& m0, T& m1) {
  using K = Key<T>;
  using U = typename K::U;
  using CC = ClCode<W>;
  const T inf = inf_v<T>();
  const U key_inf = K::enc(inf);
  const int nt = (int)blockDim.x;
#pragma unroll(G == 1 ? 4 : 1)
  for (int j0 = (int)threadIdx.x; j0 < n; j0 += G * nt) {
    unsigned l[G], r[G];
    W c[G];
    T tl[G], th[G];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int j = j0 + u * nt;
      l[u] = j < n ? rec[base + j] : 0u;
      r[u] = j < n ? rec[P + base + j] : 0u;
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      c[u] = cl_code<W>(l[u], r[u], (unsigned)P);
      const bool nv = CC::lo(c[u]) != CC::NONE;
      tl[u] = nv ? cl_cost_g<T, W>(CC::lo(c[u]), cft_g, has) : inf;
      th[u] = nv ? cl_cost_g<T, W>(CC::hi(c[u]), cft_g, has) : inf;
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int j = j0 + u * nt;
      if (j < n) {
        st_shared(codes + (unsigned)sizeof(W) * (unsigned)j, c[u]);
        const bool nv = CC::lo(c[u]) != CC::NONE;
        const uint32_t kp = key + (unsigned)j * (unsigned)sizeof(U);
        const T fv = restart ? (base + j == 0 ? T(0) : inf) : K::dec(ld_shared<U>(kp));
        st_shared(kp, key_inf);  // no peer reaches it before the cluster barrier
        m0 = min_v(m0, nv ? fv + lo + tl[u] : inf);
        m1 = min_v(m1, nv ? fv + hi + th[u] : inf);
        fout[base + j] = fv;
      }
    }
  }
}

// One arrival `v` at child `slot`, into the key row (shared address `key`)
// of the block that keeps it: float32 keys by red.shared::cluster.min.u32,
// float64 keys by red.shared.min.u64 into the block's own row and by
// compare-and-swap into a peer's (red_min_cluster). Measured on knapsack48's
// rows of 32,768 slots in float64 (chip runs, PERF.md section 6): 2.08 ms a
// forward half-sweep, against 2.91 ms with every arrival by
// compare-and-swap.
template <typename U, typename W>
__device__ __forceinline__ void cl_relax(uint32_t key, unsigned slot, const Share<W>& sh, U v) {
  const unsigned q = sh.block(slot);
  const uint32_t at = key + (slot - q * sh.S) * (unsigned)sizeof(U);
  if constexpr (sizeof(U) == 8) {
    if (q == cluster_rank()) {
      red_min_shared(at, v);
      return;
    }
  }
  red_min_cluster(cluster_map(at, q), v);
}

// The forward relaxation from the block's slots into the keys of whichever
// block keeps each child; cfr read back from this hop's output (in L2)
template <typename T, typename W, int G>
__device__ __forceinline__ void cl_relax_pass(int base, int n, uint32_t key, uint32_t codes,
                                              const T* fout, T nl, T nh, const Share<W>& sh) {
  using K = Key<T>;
  using CC = ClCode<W>;
  const int nt = (int)blockDim.x;
#pragma unroll(G == 1 ? 4 : 1)
  for (int j0 = (int)threadIdx.x; j0 < n; j0 += G * nt) {
    W c[G];
    T fv[G];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int j = j0 + u * nt;
      c[u] = j < n ? ld_shared<W>(codes + (unsigned)sizeof(W) * (unsigned)j) : W(CC::NONE);
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const unsigned lc = CC::lo(c[u]), hc = CC::hi(c[u]);
      const bool any = lc != CC::NONE && (lc < CC::NONE || hc < CC::NONE);
      fv[u] = any ? __ldcg(fout + base + j0 + u * nt) : T(0);
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const unsigned lc = CC::lo(c[u]), hc = CC::hi(c[u]);
      if (lc != CC::NONE) {
        if (lc < CC::NONE) cl_relax(key, lc, sh, K::enc(fv[u] + nl));
        if (hc < CC::NONE) cl_relax(key, hc, sh, K::enc(fv[u] + nh));
      }
    }
  }
}

// The backward's first pass: the slot codes into their row and the
// partials of the min-marginals, from cfr of this hop (the block's slots,
// device memory) and the children's cft of hop h+1 in the cluster's row
template <typename T, typename W, int G>
__device__ __forceinline__ void cl_backward_pass(const uint32_t* rec, const T* cfr, int P,
                                                 int base, int n, uint32_t codes, uint32_t rin,
                                                 bool has, T lo, T hi, T& m0, T& m1,
                                                 const Share<W>& sh) {
  using CC = ClCode<W>;
  const T inf = inf_v<T>();
  const int nt = (int)blockDim.x;
#pragma unroll(G == 1 ? 4 : 1)
  for (int j0 = (int)threadIdx.x; j0 < n; j0 += G * nt) {
    unsigned l[G], r[G];
    T cf[G];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int j = j0 + u * nt;
      l[u] = j < n ? rec[base + j] : 0u;
      r[u] = j < n ? rec[P + base + j] : 0u;
      cf[u] = j < n ? cfr[base + j] : T(0);
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int j = j0 + u * nt;
      const W c = cl_code<W>(l[u], r[u], (unsigned)P);
      if (j < n) st_shared(codes + (unsigned)sizeof(W) * (unsigned)j, c);
      const bool nv = CC::lo(c) != CC::NONE;  // false past the block's slots
      const T tl = nv ? cl_cost<T>(CC::lo(c), rin, sh, has) : inf;
      const T th = nv ? cl_cost<T>(CC::hi(c), rin, sh, has) : inf;
      m0 = min_v(m0, nv ? cf[u] + lo + tl : inf);
      m1 = min_v(m1, nv ? cf[u] + hi + th : inf);
    }
  }
}

// cft of the block's slots from the new costs (nl, nh): out to device
// memory and, with two rows, into the row being built (`rout`); the run
// decodes the record here, the backward reads the codes its first pass wrote
template <typename T, typename W, bool RUN, int G>
__device__ __forceinline__ void cl_cft_pass(const uint32_t* rec, int P, int base, int n,
                                            uint32_t codes, uint32_t rin, bool has, T nl, T nh,
                                            T* fout, uint32_t rout, bool two_rows,
                                            const Share<W>& sh) {
  using CC = ClCode<W>;
  const T inf = inf_v<T>();
  const int nt = (int)blockDim.x;
#pragma unroll(G == 1 ? 4 : 1)
  for (int j0 = (int)threadIdx.x; j0 < n; j0 += G * nt) {
    W c[G];
    if constexpr (RUN) {
      unsigned l[G], r[G];
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const int j = j0 + u * nt;
        l[u] = j < n ? rec[base + j] : 0u;
        r[u] = j < n ? rec[P + base + j] : 0u;
      }
#pragma unroll
      for (int u = 0; u < G; ++u) c[u] = cl_code<W>(l[u], r[u], (unsigned)P);
    } else {
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const int j = j0 + u * nt;
        c[u] = j < n ? ld_shared<W>(codes + (unsigned)sizeof(W) * (unsigned)j) : W(CC::NONE);
      }
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int j = j0 + u * nt;
      const bool nv = CC::lo(c[u]) != CC::NONE;
      const T tl = nv ? cl_cost<T>(CC::lo(c[u]), rin, sh, has) : inf;
      const T th = nv ? cl_cost<T>(CC::hi(c[u]), rin, sh, has) : inf;
      const T v = nv ? min_v(nl + tl, nh + th) : inf;
      if (j < n) {
        fout[base + j] = v;
        if (two_rows) st_shared(rout + (unsigned)j * (unsigned)sizeof(T), v);
      }
    }
  }
}

// min of (m0, m1) over the cluster, the same in every thread of every
// block: over the block (block_min2_once), then each block stores its pair
// into slot `rank` of every block's row of pairs, one cluster barrier, and
// every thread takes the min over the C pairs in rank order. `first`: the
// block's first access to a peer, which waits for the start-up barrier.
template <typename T>
__device__ __forceinline__ void cluster_min2(T& m0, T& m1, T* red, T* pairs, unsigned C,
                                             unsigned rank, bool first) {
  block_min2_once(m0, m1, red);
  if (first) cluster_wait();
  if (threadIdx.x < C) {
    const uint32_t at = cluster_map(smem_addr(pairs + 2 * rank), threadIdx.x);
    st_cluster(at, m0);
    st_cluster(at + (unsigned)sizeof(T), m1);
  }
  cluster_sync();
  T x = pairs[0], y = pairs[1];
  for (unsigned k = 1; k < C; ++k) {
    x = min_v(x, pairs[2 * k]);
    y = min_v(y, pairs[2 * k + 1]);
  }
  m0 = x;
  m1 = y;
}

// Dynamic shared memory of a block (solver/layout.py, cluster_smem_bytes):
// [row 0 | row 1 (backward, where the table's last column is 2) | the slot
//  codes, pad16(sizeof(W) S) | 64 values of partials | 2 CLUSTER_MAX values:
//  the cluster's pairs by rank | two ring slots of HUGE_SCALARS values],
// every row pad16(S values).
template <typename T, int MODE, typename W>
__device__ __forceinline__ void cluster_column(const Args<T>& a, const Bucket& bk,
                                               unsigned char* smem, long long b) {
  using K = Key<T>;
  constexpr bool FORWARD = MODE == MODE_FORWARD, RUN = MODE == MODE_BACKWARD_RUN;
  constexpr int SZ = (int)sizeof(T);
  constexpr int G = HUGE_GROUP;
  const int P = (int)bk.P, H = (int)bk.H;
  const long long B = bk.B;
  const int t = (int)threadIdx.x, nt = (int)blockDim.x;
  const unsigned C = cluster_blocks(), rank = cluster_rank();
  const unsigned S = ((unsigned)P + C - 1) / C;
  const Share<W> sh{S, 0xffffffffu / S + 1u};
  const int base = (int)(rank * S);
  const int n = max(0, min((int)S, P - base));  // the block's slots
  const bool grouped = FORWARD ? n >= G * nt : !RUN;  // as the huge body's loops
  const bool two = !FORWARD && bk.stages == 2;
  const int row_bytes = pad16((int)S * SZ);
  const uint32_t row0 = smem_addr(smem);
  const uint32_t codes = row0 + (two ? 2 : 1) * row_bytes;
  T* const red = (T*)(smem + (two ? 2 : 1) * row_bytes + pad16((int)sizeof(W) * (int)S));
  T* const pairs = red + 64;
  unsigned char* const ring = (unsigned char*)(pairs + 2 * CLUSTER_MAX);
  const int ring_bytes = HUGE_SCALARS * SZ;

  const uint32_t* const g_arcs = (const uint32_t*)(a.arcs + bk.arc_off);
  const T* const g_front = RUN ? nullptr : a.frontier + bk.node_off;  // rows [H, B, P]
  T* const g_out = a.out_frontier + bk.node_off;
  const int nscalars = RUN ? 2 : (a.omega_arr ? 6 : 5);
  // the layer values of hop h into a ring slot
  auto copy_layer = [&](int h, unsigned char* dst) {
    const size_t e = (size_t)bk.row_off + (size_t)h * B + b;
    if (t < nscalars) {
      const T* src = t == 0 ? a.lo : t == 1 ? a.hi : t == 2 ? a.din_lo : t == 3 ? a.din_hi
                     : t == 4 ? a.alpha : a.omega_arr;
      cp_async<SZ>(dst + t * SZ, src + e);
    }
  };

  if constexpr (FORWARD) {
    for (int j = t; j < n; j += nt) st_shared(row0 + (unsigned)j * (unsigned)SZ, K::enc(inf_v<T>()));
  }
  copy_layer(FORWARD ? 0 : H - 1, ring);
  cp_commit();
  cp_wait(0);
  __syncthreads();
  cluster_arrive();  // the start-up barrier: waited for before the first access to a peer

  uint32_t rin = row0;                            // backward: cft of hop h+1
  uint32_t rout = two ? row0 + row_bytes : row0;  // the row being built
  for (int i = 0; i < H; ++i) {
    const int h = FORWARD ? i : H - 1 - i;
    unsigned char* const cur = ring + (i & 1) * ring_bytes;
    if (i + 1 < H) copy_layer(FORWARD ? h + 1 : h - 1, ring + ((i + 1) & 1) * ring_bytes);
    cp_commit();
    const size_t col = (size_t)h * B + b;
    const uint32_t* rec = g_arcs + col * 2 * P;
    const unsigned w_layer = rec[P], w_root = rec[P + 1];
    const T* sc = (const T*)cur;
    const T lo = sc[0], hi = sc[1];
    T* fout = g_out + col * P;
    T nl = lo, nh = hi, mm = T(0);
    const bool has = h + 1 < H;  // cft of hop h+1 (none past the last hop)

    if constexpr (FORWARD) {
      const bool restart = Arc<uint32_t>::flag(w_root) != 0;  // also the hop-0 init
      const T* cft_next = g_front + (col + (size_t)B) * P;
      T m0 = inf_v<T>(), m1 = inf_v<T>();
      if (grouped)
        cl_forward_pass<T, W, G>(rec, P, base, n, row0, codes, cft_next, has, restart, lo, hi,
                                 fout, m0, m1);
      else
        cl_forward_pass<T, W, 1>(rec, P, base, n, row0, codes, cft_next, has, restart, lo, hi,
                                 fout, m0, m1);
      cluster_min2(m0, m1, red, pairs, C, rank, i == 0);  // also: every reset is visible
      hop_cost_update(lo, hi, m0, m1, a.omega_arr ? sc[5] : a.omega, sc[4], sc[2], sc[3],
                      Arc<uint32_t>::flag(w_layer) != 0, nl, nh, mm);
      if (grouped)
        cl_relax_pass<T, W, G>(base, n, row0, codes, fout, nl, nh, sh);
      else
        cl_relax_pass<T, W, 1>(base, n, row0, codes, fout, nl, nh, sh);
    } else {
      if constexpr (!RUN) {
        const T* cfr = g_front + col * P;  // cfr of this hop
        T m0 = inf_v<T>(), m1 = inf_v<T>();
        if (i == 0) cluster_wait();
        if (grouped)
          cl_backward_pass<T, W, G>(rec, cfr, P, base, n, codes, rin, has, lo, hi, m0, m1, sh);
        else
          cl_backward_pass<T, W, 1>(rec, cfr, P, base, n, codes, rin, has, lo, hi, m0, m1, sh);
        cluster_min2(m0, m1, red, pairs, C, rank, false);
        hop_cost_update(lo, hi, m0, m1, a.omega_arr ? sc[5] : a.omega, sc[4], sc[2], sc[3],
                        Arc<uint32_t>::flag(w_layer) != 0, nl, nh, mm);
      } else {
        if (i == 0) cluster_wait();
      }
      if (grouped)
        cl_cft_pass<T, W, RUN, G>(rec, P, base, n, codes, rin, has, nl, nh, fout, rout, two, sh);
      else
        cl_cft_pass<T, W, RUN, 1>(rec, P, base, n, codes, rin, has, nl, nh, fout, rout, two, sh);
      if (!two) {
        cluster_sync();  // every peer's gather from the row is done before it is overwritten
        copy_back(fout + base, n, rout);
      }
    }
    if constexpr (!RUN) {
      if (t == 0 && rank == 0) {
        const size_t e = (size_t)bk.row_off + col;
        a.out_lo[e] = nl;
        a.out_hi[e] = nh;
        a.out_mm[e] = mm;
      }
    }
    cp_wait(0);      // the next hop's ring slot has landed
    cluster_sync();  // every arrival and row is in, and this hop's ring slot is free
    if (two) {
      const uint32_t swap = rin;
      rin = rout;
      rout = swap;
    }
  }
}

// W: the slot code of every bucket of the table (ClCode), chosen by the
// launch from the widest
template <typename T, int MODE, typename W>
__global__ void __launch_bounds__(HUGE_MAX_THREADS, 1) sweep_huge_cluster_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int k = 0;
  while (k + 1 < a.nr_buckets && (long long)blockIdx.x >= a.table[k + 1].first_block) ++k;
  const Bucket bk = a.table[k];
  // the column: a bucket's blocks are its columns' clusters in order
  const long long b = ((long long)blockIdx.x - bk.first_block) / (long long)cluster_blocks();
  cluster_column<T, MODE, W>(a, bk, smem, b);
}

// once per instantiation: above 48 KB of shared memory a kernel must ask,
// and a cluster of 16 blocks (a non-portable size) must be allowed before a
// launch or the occupancy query takes one
template <typename T, int MODE, typename W>
int cluster_opt_in() {
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t rc =
        cudaFuncSetAttribute(sweep_huge_cluster_kernel<T, MODE, W>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_DYNAMIC_SMEM);
    if (rc != cudaSuccess) return (int)rc;
    rc = cudaFuncSetAttribute(sweep_huge_cluster_kernel<T, MODE, W>,
                              cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (rc != cudaSuccess) return (int)rc;
    opted_in = true;
  }
  return 0;
}

cudaLaunchConfig_t cluster_config(int nr_blocks, int threads, int cluster, int smem_bytes,
                                  cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)nr_blocks);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// as `launch_huge`, over the table of the cluster body: `cluster` blocks of
// `threads` threads a column (cudaLaunchKernelEx with a cluster dimension,
// a runtime value), `pmax` the widest bucket, whose width sets the slot
// code of the launch: four bytes up to CL_MAX_P, else eight. A cluster that
// cannot be placed is refused by the launch, and the code returned.
template <typename T, int MODE, typename W>
int launch_cluster_code(const Args<T>& a, const Launch& r, int smem_bytes, cudaStream_t s) {
  const int rc = cluster_opt_in<T, MODE, W>();
  if (rc) return rc;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(r.blocks, r.threads, r.own[0], smem_bytes, s,
                                                attr);
  const cudaError_t launched =
      cudaLaunchKernelEx(&cfg, sweep_huge_cluster_kernel<T, MODE, W>, a);
  if (launched != cudaSuccess) return (int)launched;
  return (int)cudaGetLastError();
}

template <typename T, int MODE>
int launch_huge_cluster(const Args<T>& a, const Launch& r, int smem_bytes, cudaStream_t s) {
  const int nr_blocks = r.blocks, threads = r.threads, cluster = r.own[0], pmax = r.own[1];
  if (nr_blocks == 0) return 0;
  if (threads < 32 || threads > HUGE_MAX_THREADS || threads % 32 || pmax < 1 ||
      pmax > (int)HUGE_SLOT_MASK)
    return -2;
  if ((cluster != 2 && cluster != 4 && cluster != 8 && cluster != CLUSTER_MAX) ||
      nr_blocks % cluster)
    return -2;
  if (smem_bytes < 1 || smem_bytes > MAX_DYNAMIC_SMEM) return -1;
  if (pmax <= CL_MAX_P) return launch_cluster_code<T, MODE, unsigned>(a, r, smem_bytes, s);
  return launch_cluster_code<T, MODE, unsigned long long>(a, r, smem_bytes, s);
}

// how many clusters of `cluster` blocks of `threads` threads and
// `smem_bytes` of shared memory the card holds at once (the forward kernel
// of the slot code a table of widest bucket `pmax` takes;
// cudaOccupancyMaxActiveClusters), into *clusters
template <typename T, typename W>
int cluster_occupancy_code(int cluster, int threads, int smem_bytes, int* clusters) {
  const int rc = cluster_opt_in<T, MODE_FORWARD, W>();
  if (rc) return rc;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(cluster, threads, cluster, smem_bytes, nullptr,
                                                attr);
  return (int)cudaOccupancyMaxActiveClusters(
      clusters, (const void*)sweep_huge_cluster_kernel<T, MODE_FORWARD, W>, &cfg);
}
template <typename T>
int cluster_occupancy(int cluster, int threads, int smem_bytes, int pmax, int* clusters) {
  if (pmax <= CL_MAX_P)
    return cluster_occupancy_code<T, unsigned>(cluster, threads, smem_bytes, clusters);
  return cluster_occupancy_code<T, unsigned long long>(cluster, threads, smem_bytes, clusters);
}

// ------------------------------------------- huge buckets: the L2 body
// The L2 form of the huge body (see the huge section's note): each column of
// an L2 bucket spread over G blocks (the record's own[0]), its rows in device
// memory, served from L2. Block g of a column owns the chunks of L2_CHUNK
// slots (a warp's) whose index is g modulo G; warp w of the block takes the
// block's chunks w, w + warps, ..., a lane one slot of each
// (layout.l2_slots mirrors it). Per forward hop, two hop barriers of the
// column (below): each block decodes its slots (or the root restart), writes
// them out as cfr, takes its pair of partial min-marginals and resets its
// slots of the next key row to +inf; barrier A (the partials are visible,
// and every reset is ordered before any other block's atomicMin lands
// there); every block reduces the column's G partials in one order (warp 0,
// in every block alike) and makes the same cost update; each block relaxes
// its slots' arcs by a global atomicMin on Key<T> into the column's next row
// in the scratch; barrier B (the row is complete). Per backward hop: the
// partials, from cfr of the hop and the children's cft in the row of hop
// h+1 that the column wrote one hop before (__ldcg, after that hop's barrier
// B); barrier A; the cost update; the block's slots of cft; barrier B. The
// run: its slots of cft, one barrier. Block 0 of the column writes the
// layer's outputs. G = 1 is a block a column, the hop barrier a
// __syncthreads and the partials the block's own: the body as it was before
// the column was spread. A gather or a relaxation touches only a slot that
// holds a node (most slots of a layer hold none).
//
// The hop barrier of a column (ColumnBarrier): __syncthreads; thread 0 adds
// one to the column's counter with red.release.gpu (a release: what the
// block wrote before the __syncthreads is visible before its arrival) and
// spins on an ld.acquire.gpu of it until the column's G blocks have all
// arrived (an acquire: what they wrote is visible, to the block through the
// next __syncthreads); __syncthreads. The release and the acquire order the
// memory themselves, so no fence stands beside them (variant l2_fenced of
// chip_smoke.py --huge-split barrier adds __threadfence on both sides).
// Counters are per column, not per grid: one launch
// holds L2 buckets of different H, whose columns pass different numbers of
// barriers. Each launch zeroes its counters on the stream first
// (cudaMemsetAsync, no host sync), so a barrier's target is G times the
// barriers passed. Blocks wait for other blocks, so where G > 1 the grid is
// launched cooperatively (cudaLaunchKernelEx, cudaLaunchAttributeCooperative):
// the card places every block at once or refuses the launch, and the refusal
// comes back as the entry's code (the wrapper raises). Rows written in the
// launch are read back with __ldcg (L2), never through L1.
//
// What it answers: with one block a column (the first form) a row of 262,144
// slots over 2 columns kept 2 of the 132 SMs busy, each of their threads
// walking 256 slots a hop as chains of dependent loads and atomics: 274 us a
// forward hop against about 3.7 us of bytes (chip_smoke.py, phase 6, on an
// NVIDIA H100 80GB HBM3 at 700 W; PERF.md section 6). The plan takes G from the card's resident blocks over the L2
// columns (66 at 2 columns), so every SM works on the column and a thread
// on about 4 slots a hop, their loads issued HUGE_GROUP at a time. Chunks of
// a warp, dealt out in turn, spread a layer whose nodes fill its low slots
// over every block of the column.
// Scratch (layout.huge_scratch, three parts): the forward's key rows [B, 2,
// P] per bucket (the table's last column is the bucket's offset, in values),
// then, where G > 1, the partials [columns, G, 2] values and the counters
// [columns] (u32). A column's place in them is first_block / G + b.
//
// The counting entries (sweep_huge_l2_counted_kernel, "_count" in the entry's
// name) are the same body with the hop barrier timed: thread 0 of a block
// reads clock64 before its arrival and after its spin, and at the block's
// end adds its summed wait and its cycles since it began to a pair of
// 64-bit accumulators, one atomic each. Both are SM cycles of one block, so
// their ratio needs no clock rate; G = 1 returns before the spin and waits
// 0. The entries without "_count" compile the body without it (the clock
// reads and the accumulators exist only in the counting instantiation,
// ColumnBarrier<true>), so their registers, and the blocks an SM holds, which G
// comes from, are the body's own.
__device__ __forceinline__ unsigned huge_flag(uint32_t w) { return (w >> 30) & 1u; }

constexpr int L2_CHUNK = 32;        // slots a chunk of a block's share: a warp's
constexpr int L2_MAX_SPLIT = 256;   // blocks a column, at most (layout.L2_MAX_SPLIT)

struct L2Scratch {
  unsigned char* rows;  // the forward's key rows
  void* partials;       // [columns, G, 2] values (G > 1)
  unsigned* counters;   // [columns] arrivals at the column's barriers (G > 1)
  int split;            // G: blocks a column
};

__device__ __forceinline__ void red_release_add(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// the hop barrier of one column of `blocks` blocks (see above); `passed`
// counts the arrivals the column's counter has seen at this block's last one.
// TIMED (the counting entries): thread 0 also sums in `wait` the SM cycles
// from before its arrival to the end of its spin
template <bool TIMED>
struct ColumnBarrier {
  unsigned* counter;
  unsigned blocks, passed;
  long long wait = 0;
  __device__ __forceinline__ void sync() {
    __syncthreads();
    if (blocks == 1) return;
    passed += blocks;
    if (threadIdx.x == 0) {
      [[maybe_unused]] const long long t0 = TIMED ? clock64() : 0;
      red_release_add(counter, 1u);
      while (ld_acquire(counter) < passed) {
      }
      if constexpr (TIMED) wait += clock64() - t0;
    }
    __syncthreads();
  }
};

// min of (m0, m1) over the block, in every thread; `red` is [64] in shared
// memory, free again once the block has passed its next barrier
template <typename T>
__device__ __forceinline__ void block_min2(T& m0, T& m1, T* red) {
  const int lane = (int)threadIdx.x & 31, warp = (int)threadIdx.x >> 5;
  const int warps = (int)blockDim.x >> 5;
  m0 = warp_min(m0);
  m1 = warp_min(m1);
  if (lane == 0) {
    red[warp] = m0;
    red[32 + warp] = m1;
  }
  __syncthreads();
  T x = red[0], y = red[32];
  for (int w = 1; w < warps; ++w) {
    x = min_v(x, red[w]);
    y = min_v(y, red[32 + w]);
  }
  m0 = x;
  m1 = y;
}

// min of (m0, m1) over the column, the same in every thread of its G
// blocks: over the block, warp 0 stores the block's pair as partial g, the
// column's barrier A, and warp 0 of every block reduces the G pairs in one
// order (lane-strided, then the butterfly; lane 0's result, broadcast
// through `red`). G = 1: the block's own reduction.
template <typename T, typename Bar>
__device__ __forceinline__ void column_min2(T& m0, T& m1, T* red, T* part, int g, Bar& bar) {
  const int G = (int)bar.blocks;
  if (G == 1) {
    block_min2(m0, m1, red);
    return;
  }
  const int lane = (int)threadIdx.x & 31, warp = (int)threadIdx.x >> 5;
  const int warps = (int)blockDim.x >> 5;
  const T inf = inf_v<T>();
  m0 = warp_min(m0);
  m1 = warp_min(m1);
  if (lane == 0) {
    red[warp] = m0;
    red[32 + warp] = m1;
  }
  __syncthreads();
  if (warp == 0) {
    const T x = warp_min(lane < warps ? red[lane] : inf);
    const T y = warp_min(lane < warps ? red[32 + lane] : inf);
    if (lane == 0) {
      part[2 * g] = x;
      part[2 * g + 1] = y;
    }
  }
  bar.sync();  // barrier A
  if (warp == 0) {
    T x = inf, y = inf;
    for (int q = lane; q < G; q += 32) {
      x = min_v(x, __ldcg(part + 2 * q));
      y = min_v(y, __ldcg(part + 2 * q + 1));
    }
    x = warp_min(x);
    y = warp_min(y);
    if (lane == 0) {
      red[0] = x;
      red[32] = y;
    }
  }
  __syncthreads();
  m0 = red[0];
  m1 = red[32];
}

// a child's cost from its arc word: TOP 0, BOT +inf, an internal arc the
// row's value at its slot (`row` null: past the last hop, +inf; a slot
// outside the bucket: 0, as the twins); `L2`: the row was written in this
// launch (__ldcg), else it is an input (__ldg)
template <typename T, bool L2>
__device__ __forceinline__ T l2_child(uint32_t w, long long P, const T* row) {
  const unsigned kind = w & 3u;
  if (kind != ARC_INTERNAL) return kind == ARC_TOP ? T(0) : inf_v<T>();
  const long long slot = (w >> 2) & HUGE_SLOT_MASK;
  if (slot >= P) return T(0);
  if (row == nullptr) return inf_v<T>();
  if constexpr (L2) return __ldcg(row + slot);
  else return __ldg(row + slot);
}

// the L2 body; COUNT: the counting instantiation, which adds thread 0's
// barrier wait and its block's cycles to acc[0] and acc[1]
template <typename T, int MODE, bool COUNT>
__device__ __forceinline__ void huge_l2_body(Args<T> a, L2Scratch s,
                                             unsigned long long* acc) {
  using K = Key<T>;
  using U = typename K::U;
  constexpr bool FORWARD = MODE == MODE_FORWARD, RUN = MODE == MODE_BACKWARD_RUN;
  constexpr int GR = HUGE_GROUP;
  long long started = 0;
  if constexpr (COUNT) {
    if (threadIdx.x == 0) started = clock64();
  }
  __shared__ T red[64];
  int k = 0;
  while (k + 1 < a.nr_buckets && (long long)blockIdx.x >= a.table[k + 1].first_block) ++k;
  const Bucket bk = a.table[k];
  const long long P = bk.P, B = bk.B;
  const int H = (int)bk.H;
  const int G = s.split;
  const long long j = (long long)blockIdx.x - bk.first_block;
  const long long b = j / G;         // the column
  const int g = (int)(j - b * G);    // this block's share of it
  const long long column = bk.first_block / G + b;  // its place in the partials and counters
  const int lane = (int)threadIdx.x & 31, warp = (int)threadIdx.x >> 5;
  const int warps = (int)blockDim.x >> 5;
  // this thread's slots: first, first + stride, ... (layout.l2_slots)
  const long long first = ((long long)warp * G + g) * L2_CHUNK + lane;
  const long long stride = (long long)warps * G * L2_CHUNK;
  ColumnBarrier<COUNT> bar{G > 1 ? s.counters + column : nullptr, (unsigned)G, 0u};
  T* const part = G > 1 ? (T*)s.partials + column * 2 * G : nullptr;
  const T inf = inf_v<T>();
  const uint32_t* g_arcs = (const uint32_t*)(a.arcs + bk.arc_off);
  const T* g_front = RUN ? nullptr : a.frontier + bk.node_off;  // rows [H, B, P]
  T* g_out = a.out_frontier + bk.node_off;
  // forward: this column's key rows in the scratch (the table's last
  // column is the bucket's offset into them, in values)
  U* row_a = FORWARD ? (U*)s.rows + bk.stages + b * 2 * P : nullptr;
  U* row_b = FORWARD ? row_a + P : nullptr;
  if constexpr (FORWARD) {
    // only this thread reads its slots of row_a before the first barrier
    for (long long p = first; p < P; p += stride) row_a[p] = K::enc(inf);
  }

  for (int i = 0; i < H; ++i) {
    const int h = FORWARD ? i : H - 1 - i;
    const size_t col = (size_t)h * B + b;
    const uint32_t* rec = g_arcs + col * 2 * P;
    const size_t e = (size_t)bk.row_off + col;
    const T lo = __ldg(a.lo + e), hi = __ldg(a.hi + e);
    T* fout_h = g_out + col * P;
    T m0 = inf, m1 = inf, nl = lo, nh = hi, mm = T(0);

    if constexpr (FORWARD) {
      const U* cur = row_a;
      U* nxt = row_b;
      const bool restart = huge_flag(__ldg(rec + P + 1)) != 0;  // also the hop-0 init
      const T* fr = h + 1 < H ? g_front + (col + B) * P : nullptr;  // cft of hop h+1
      const U key_inf = K::enc(inf);
      for (long long p0 = first; p0 < P; p0 += GR * stride) {
        uint32_t lb[GR], hb[GR];
        T f[GR], tl[GR], th[GR];
#pragma unroll
        for (int u = 0; u < GR; ++u) {
          const long long p = p0 + u * stride;
          const bool in = p < P;
          lb[u] = in ? __ldg(rec + p) : 0u;
          hb[u] = in ? __ldg(rec + P + p) : 0u;
          f[u] = restart ? (p == 0 ? T(0) : inf) : (in ? K::dec(__ldcg(cur + p)) : inf);
        }
#pragma unroll
        for (int u = 0; u < GR; ++u) {
          const bool nv = huge_flag(lb[u]) != 0;
          tl[u] = nv ? l2_child<T, false>(lb[u], P, fr) : inf;
          th[u] = nv ? l2_child<T, false>(hb[u], P, fr) : inf;
        }
#pragma unroll
        for (int u = 0; u < GR; ++u) {
          const long long p = p0 + u * stride;
          if (p < P) {
            const bool nv = huge_flag(lb[u]) != 0;
            m0 = min_v(m0, nv ? f[u] + lo + tl[u] : inf);
            m1 = min_v(m1, nv ? f[u] + hi + th[u] : inf);
            fout_h[p] = f[u];
            nxt[p] = key_inf;  // no other block reaches it before barrier A
          }
        }
      }
      column_min2(m0, m1, red, part, g, bar);  // barrier A: every reset is in
      const T om = a.omega_arr ? __ldg(a.omega_arr + e) : a.omega;
      hop_cost_update(lo, hi, m0, m1, om, __ldg(a.alpha + e), __ldg(a.din_lo + e),
                      __ldg(a.din_hi + e), huge_flag(__ldg(rec + P)) != 0, nl, nh, mm);
      // relax the frontier to h+1: nxt[k] = min over valid p with an
      // internal arc into k of cfr[p] + cost of that arc
      for (long long p0 = first; p0 < P; p0 += GR * stride) {
        uint32_t lb[GR], hb[GR];
        T f[GR];
#pragma unroll
        for (int u = 0; u < GR; ++u) {
          const long long p = p0 + u * stride;
          lb[u] = p < P ? __ldg(rec + p) : 0u;
          hb[u] = p < P ? __ldg(rec + P + p) : 0u;
          const bool any = huge_flag(lb[u]) && ((lb[u] & 3u) == ARC_INTERNAL ||
                                                (hb[u] & 3u) == ARC_INTERNAL);
          f[u] = !any ? T(0) : restart ? (p == 0 ? T(0) : inf) : K::dec(__ldcg(cur + p));
        }
#pragma unroll
        for (int u = 0; u < GR; ++u) {
          if (!huge_flag(lb[u])) continue;
          const long long ls = (lb[u] >> 2) & HUGE_SLOT_MASK, hs = (hb[u] >> 2) & HUGE_SLOT_MASK;
          if ((lb[u] & 3u) == ARC_INTERNAL && ls < P) atomicMin(nxt + ls, K::enc(f[u] + nl));
          if ((hb[u] & 3u) == ARC_INTERNAL && hs < P) atomicMin(nxt + hs, K::enc(f[u] + nh));
        }
      }
    } else {
      // cft of hop h+1: the column's output of the hop before (none past the last hop)
      const T* cur = h + 1 < H ? g_out + (col + B) * P : nullptr;
      if constexpr (!RUN) {
        const T* cfr = g_front + col * P;  // cfr of this hop
        for (long long p0 = first; p0 < P; p0 += GR * stride) {
          uint32_t lb[GR], hb[GR];
          T cf[GR];
#pragma unroll
          for (int u = 0; u < GR; ++u) {
            const long long p = p0 + u * stride;
            lb[u] = p < P ? __ldg(rec + p) : 0u;
            hb[u] = p < P ? __ldg(rec + P + p) : 0u;
            cf[u] = p < P ? __ldg(cfr + p) : T(0);
          }
#pragma unroll
          for (int u = 0; u < GR; ++u) {
            const bool nv = huge_flag(lb[u]) != 0;  // false past the bucket's slots
            const T tl = nv ? l2_child<T, true>(lb[u], P, cur) : inf;
            const T th = nv ? l2_child<T, true>(hb[u], P, cur) : inf;
            m0 = min_v(m0, nv ? cf[u] + lo + tl : inf);
            m1 = min_v(m1, nv ? cf[u] + hi + th : inf);
          }
        }
        column_min2(m0, m1, red, part, g, bar);  // barrier A
        const T om = a.omega_arr ? __ldg(a.omega_arr + e) : a.omega;
        hop_cost_update(lo, hi, m0, m1, om, __ldg(a.alpha + e), __ldg(a.din_lo + e),
                        __ldg(a.din_hi + e), huge_flag(__ldg(rec + P)) != 0, nl, nh, mm);
      }
      for (long long p0 = first; p0 < P; p0 += GR * stride) {
        uint32_t lb[GR], hb[GR];
#pragma unroll
        for (int u = 0; u < GR; ++u) {
          const long long p = p0 + u * stride;
          lb[u] = p < P ? __ldg(rec + p) : 0u;
          hb[u] = p < P ? __ldg(rec + P + p) : 0u;
        }
#pragma unroll
        for (int u = 0; u < GR; ++u) {
          const long long p = p0 + u * stride;
          const bool nv = huge_flag(lb[u]) != 0;
          const T tl = nv ? l2_child<T, true>(lb[u], P, cur) : inf;
          const T th = nv ? l2_child<T, true>(hb[u], P, cur) : inf;
          if (p < P) fout_h[p] = nv ? min_v(nl + tl, nh + th) : inf;
        }
      }
    }
    if constexpr (!RUN) {
      if (g == 0 && threadIdx.x == 0) {
        a.out_lo[e] = nl;
        a.out_hi[e] = nh;
        a.out_mm[e] = mm;
      }
    }
    bar.sync();  // barrier B: the row is built before the next hop reads it
    if constexpr (FORWARD) {
      U* const swap = row_a;
      row_a = row_b;
      row_b = swap;
    }
  }
  if constexpr (COUNT) {
    if (threadIdx.x == 0) {
      atomicAdd(acc, (unsigned long long)bar.wait);
      atomicAdd(acc + 1, (unsigned long long)(clock64() - started));
    }
  }
}

template <typename T, int MODE>
__global__ void __launch_bounds__(HUGE_MAX_THREADS) sweep_huge_l2_kernel(Args<T> a,
                                                                          L2Scratch s) {
  huge_l2_body<T, MODE, false>(a, s, nullptr);
}

template <typename T, int MODE>
__global__ void __launch_bounds__(HUGE_MAX_THREADS)
    sweep_huge_l2_counted_kernel(Args<T> a, L2Scratch s, unsigned long long* acc) {
  huge_l2_body<T, MODE, true>(a, s, acc);
}

// the L2 body's kernel, or with COUNT its counting form
template <typename T, int MODE, bool COUNT>
auto l2_kernel() {
  if constexpr (COUNT) return sweep_huge_l2_counted_kernel<T, MODE>;
  else return sweep_huge_l2_kernel<T, MODE>;
}

// as `launch`, over the table of the L2 body: `split` blocks of `threads`
// threads a column over `nr_columns` columns; `rows` (the forward's key
// rows), `partials` and `counters` (where split > 1): the layout's scratch.
// split > 1 zeroes the counters and launches cooperatively; a grid the card
// cannot place at once is refused, and the code returned. COUNT: the
// counting form, into the pair `acc` (the wait, the block cycles).
template <typename T, int MODE, bool COUNT>
int launch_huge_l2(const Args<T>& a, const Launch& r, cudaStream_t s) {
  const int nr_blocks = r.blocks, threads = r.threads, split = r.own[0], nr_columns = r.own[1];
  void* const rows = r.rows;
  void* const partials = r.partials;
  void* const counters = r.counters;
  unsigned long long* const acc = r.acc;
  if (nr_blocks == 0) return 0;
  if (COUNT && acc == nullptr) return -1;
  if (threads < 32 || threads > HUGE_MAX_THREADS || threads % 32) return -2;
  if (split < 1 || split > L2_MAX_SPLIT || nr_columns < 1 ||
      (long long)nr_blocks != (long long)split * nr_columns)
    return -2;
  if (MODE == MODE_FORWARD && rows == nullptr) return -1;
  if (split > 1 && (partials == nullptr || counters == nullptr)) return -1;
  const L2Scratch sc{(unsigned char*)rows, partials, (unsigned*)counters, split};
  if (split == 1) {
    if constexpr (COUNT)
      sweep_huge_l2_counted_kernel<T, MODE><<<nr_blocks, threads, 0, s>>>(a, sc, acc);
    else
      sweep_huge_l2_kernel<T, MODE><<<nr_blocks, threads, 0, s>>>(a, sc);
    return (int)cudaGetLastError();
  }
  cudaError_t rc = cudaMemsetAsync(counters, 0, (size_t)nr_columns * sizeof(unsigned), s);
  if (rc != cudaSuccess) return (int)rc;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)nr_blocks);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if constexpr (COUNT)
    rc = cudaLaunchKernelEx(&cfg, sweep_huge_l2_counted_kernel<T, MODE>, a, sc, acc);
  else
    rc = cudaLaunchKernelEx(&cfg, sweep_huge_l2_kernel<T, MODE>, a, sc);
  if (rc != cudaSuccess) {
    cudaGetLastError();  // a refused launch is no error of the next one
    return (int)rc;
  }
  return (int)cudaGetLastError();
}

// the blocks of `threads` threads of the L2 body (COUNT: its counting form)
// an SM holds at once, the least over its three entries
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *blocks
template <typename T, bool COUNT>
int l2_occupancy(int threads, int* blocks) {
  int n[3] = {0, 0, 0};
  cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n[0], l2_kernel<T, MODE_FORWARD, COUNT>(), threads, 0);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n[1], l2_kernel<T, MODE_BACKWARD, COUNT>(), threads, 0);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n[2], l2_kernel<T, MODE_BACKWARD_RUN, COUNT>(), threads, 0);
  *blocks = n[0] < n[1] ? (n[0] < n[2] ? n[0] : n[2]) : (n[1] < n[2] ? n[1] : n[2]);
  return (int)rc;
}

// the launches of the records r[0..n) in order, over the buffers `b`; the
// code of the first that fails, its index into *failed
template <typename T, int MODE>
int launch_records(const Launch* r, int n, const Buffers* b, void* stream, int* failed) {
  Args<T> a{nullptr,          0,                    (const uint8_t*)b->arcs,
            (const T*)b->lo,  (const T*)b->hi,      (const T*)b->din_lo,
            (const T*)b->din_hi, (const T*)b->alpha, (const T*)b->omega_arr,
            (T)b->omega,      (const T*)b->frontier, (T*)b->out_lo,
            (T*)b->out_hi,    (T*)b->out_mm,        (T*)b->out_frontier};
  const cudaStream_t s = (cudaStream_t)stream;
  for (int i = 0; i < n; ++i) {
    a.table = (const Bucket*)r[i].table;
    a.nr_buckets = r[i].nr_buckets;
    const int smem = MODE == MODE_FORWARD ? r[i].smem_forward : r[i].smem_backward;
    int rc = -2;
    switch (r[i].body) {
      case BODY_NARROW: rc = launch<T, MODE>(a, r[i], smem, s); break;
      case BODY_WIDE: rc = launch_wide<T, MODE>(a, r[i], smem, s); break;
      case BODY_HUGE:
        rc = r[i].acc ? launch_huge<T, MODE, true>(a, r[i], smem, s)
                      : launch_huge<T, MODE, false>(a, r[i], smem, s);
        break;
      case BODY_CLUSTER: rc = launch_huge_cluster<T, MODE>(a, r[i], smem, s); break;
      case BODY_L2:
        rc = r[i].acc ? launch_huge_l2<T, MODE, true>(a, r[i], s)
                      : launch_huge_l2<T, MODE, false>(a, r[i], s);
        break;
      default: break;
    }
    if (rc != 0) {
      *failed = i;
      return rc;
    }
  }
  return 0;
}

// the card's answer for `body` at `threads` threads and `smem_bytes` of
// dynamic shared memory a block, `own0` and `own1` the body's own integers
// of its record (the form: the huge body's ring hops in own1, the cluster
// body's C and widest bucket): the blocks of the huge and the L2 body an SM
// holds at once (`counting`: of their counting forms), the clusters of the
// cluster body the card holds at once, into *out
template <typename T>
int body_occupancy(int body, int threads, int smem_bytes, int own0, int own1, int counting,
                   int* out) {
  *out = 0;
  switch (body) {
    case BODY_HUGE:
      return counting ? huge_occupancy<T, true>(threads, smem_bytes, own1, out)
                      : huge_occupancy<T, false>(threads, smem_bytes, own1, out);
    case BODY_CLUSTER:
      return counting ? -2 : cluster_occupancy<T>(own0, threads, smem_bytes, own1, out);
    case BODY_L2:
      return counting ? l2_occupancy<T, true>(threads, out) : l2_occupancy<T, false>(threads, out);
    default: return -2;
  }
}

}  // namespace

// (records, n, buffers, stream, failed): the launches of a plan's records
// for one entry and precision, in order (the run entries' records are the
// run's own route); 0, or the code of the first launch that failed and its
// index into *failed
#define SWEEP_ENTRY(NAME, T, MODE)                                                   \
  extern "C" int NAME(const Launch* r, int n, const Buffers* b, void* stream,       \
                      int* failed) {                                                \
    return launch_records<T, MODE>(r, n, b, stream, failed);                        \
  }

SWEEP_ENTRY(uniform_forward_f32, float, MODE_FORWARD)
SWEEP_ENTRY(uniform_forward_f64, double, MODE_FORWARD)
SWEEP_ENTRY(uniform_backward_f32, float, MODE_BACKWARD)
SWEEP_ENTRY(uniform_backward_f64, double, MODE_BACKWARD)
SWEEP_ENTRY(uniform_backward_run_f32, float, MODE_BACKWARD_RUN)
SWEEP_ENTRY(uniform_backward_run_f64, double, MODE_BACKWARD_RUN)

// (body, threads, smem_bytes, own0, own1, counting, out): body_occupancy
// (solver/layout.py sizes the threads a block of the huge and the cluster
// body, the cluster size and the L2 body's blocks a column from the
// answers; the wrapper counts only where a counting form holds as many
// blocks an SM as the body's own)
extern "C" int uniform_occupancy_f32(int body, int threads, int smem_bytes, int own0, int own1,
                                     int counting, int* out) {
  return body_occupancy<float>(body, threads, smem_bytes, own0, own1, counting, out);
}
extern "C" int uniform_occupancy_f64(int body, int threads, int smem_bytes, int own0, int own1,
                                     int counting, int* out) {
  return body_occupancy<double>(body, threads, smem_bytes, own0, own1, counting, out);
}

// the sizes and field offsets of Launch and Buffers, which _build's ctypes
// mirrors must equal
extern "C" const long long uniform_record_layout[] = {
    sizeof(Launch),
    offsetof(Launch, table),
    offsetof(Launch, body),
    offsetof(Launch, nr_buckets),
    offsetof(Launch, blocks),
    offsetof(Launch, threads),
    offsetof(Launch, smem_forward),
    offsetof(Launch, smem_backward),
    offsetof(Launch, own),
    offsetof(Launch, rows),
    offsetof(Launch, partials),
    offsetof(Launch, counters),
    offsetof(Launch, acc),
    sizeof(Buffers),
    offsetof(Buffers, arcs),
    offsetof(Buffers, lo),
    offsetof(Buffers, hi),
    offsetof(Buffers, din_lo),
    offsetof(Buffers, din_hi),
    offsetof(Buffers, alpha),
    offsetof(Buffers, omega_arr),
    offsetof(Buffers, omega),
    offsetof(Buffers, frontier),
    offsetof(Buffers, out_lo),
    offsetof(Buffers, out_hi),
    offsetof(Buffers, out_mm),
    offsetof(Buffers, out_frontier),
};
