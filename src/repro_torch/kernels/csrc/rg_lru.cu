// RG-LRU linear recurrence for sm_90a, plain C interface.
//
// Replaces the TPU kernel `_rg_lru_kernel` / `rg_lru_bsw` of
// src/repro/kernels/rg_lru.py.  Same function: h_t = a_t * h_{t-1} + x_t over
// (B, S, W) f32, h_{-1} = 0, the whole trajectory h written out (the caller
// folds an initial state into x[:, 0]).
//
// Bound on an H100: bytes (a and x read once, h written once: 12 bytes per
// element for 2 FLOP).  The recurrence is sequential in S and independent per
// (batch, channel).  One pass, a and x read from device memory once:
//   * A block owns a tile of CH = 32 channels (one per lane, so a warp load is
//     one 128-byte row) by a chunk of CHUNK = WARPS * ROWS rows of S, and S is
//     split across blocks: recurrentgemma-2b's B=1 S=5000 W=2560 is 80 tiles x
//     40 chunks = 3,200 blocks, 4 resident on each SM.
//   1. Each thread loads its ROWS rows of a and x into registers, every load
//      issued before the first use.
//   2. Each warp scans its rows from h = 0 (fmaf), keeping their product and
//      end value; the block folds its warps' pairs in order into the chunk's
//      aggregate (P, E) per channel.
//   3. The state entering chunk i is c_i of ONE fixed order: c_0 = 0,
//      c_{j+1} = fmaf(P_j, c_j, E_j).  Every ANCHOR-th chunk (an anchor)
//      publishes its inclusive state c_{j+1}, every other chunk its (P, E);
//      chunk i folds, from c = 0, the slots of chunks g .. i-1, where g is the
//      last anchor below i (an anchor's slot holds (0, c_{g+1}), and
//      fmaf(0, 0, c) = c).  Each step is the same fmaf on the same values as
//      the fold from chunk 0, so every chunk gets the same c_i, bit for bit,
//      whoever computed the prefix and whenever (no order depends on timing),
//      and every call returns the same bits.  A chunk waits for at most ANCHOR
//      slots, and the anchors chain only every ANCHOR-th chunk (9 links at
//      S=5000).  On an H100, chaining every chunk took 0.105 ms at B=1 S=5000
//      and folding all earlier chunks in every block 0.080 ms; anchors every
//      4 chunks beat 2, 3, 8 and 16.
//   4. Warp w's entering state is c carried through warps 0 .. w-1 in order;
//      each warp reruns the fmaf chain over the rows still in its registers
//      and writes h.
// Forward progress: a block takes its (batch, tile, chunk) from an atomic
// ticket in chunk-major order, not from blockIdx, so it only ever waits on
// blocks that took a ticket before it, which therefore run; a non-anchor
// publishes before it waits, an anchor waits only on lower tickets.
//
// Scratch: one int64 buffer per (device, stream), zeroed once when it is made
// and never between calls (so nothing but this launch runs per call, in a CUDA
// graph too).  Word 0 holds the calls' count above COUNT_BITS tickets: one
// atomic gives a block its ticket and the call's parity, and the block with
// the call's last ticket turns the word to the next call's.  A slot, one per
// (batch, tile, chunk) and bank, is a word per channel: (P, E) as one 64-bit
// word, stored and loaded whole, never 0 (see `encode`), so a reader needs no
// flag and no fence: a word that is not 0 is the pair.  Calls alternate
// between two banks by parity.  Each call empties the other bank's slots that
// the call before it used (their count is in header word 1 + bank), so the
// next call finds every slot of its bank at 0, in a CUDA graph's replays too.
// A call of one chunk (S <= CHUNK) takes no ticket and touches no scratch.
// Ragged edges: rows past S are padded with a = 1, x = 0 (which leave h and the
// product unchanged) and channels past W are masked.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int CH = 32;                 // channels per tile, one per lane
constexpr int WARPS = 8;               // warps per block
constexpr int ROWS = 16;               // rows of S per warp, held in registers
constexpr int CHUNK = WARPS * ROWS;    // rows of S per block
constexpr int THREADS = CH * WARPS;
constexpr int MIN_BLOCKS = 4;          // per SM: at most 64 registers a thread
constexpr int ANCHOR = 4;              // every ANCHOR-th chunk publishes its inclusive state
constexpr int HEADER = 4;              // int64 words: call and ticket, slots used on banks 0, 1
constexpr int SLOT = CH;               // int64 words per slot: a (P, E) pair per lane
constexpr int COUNT_BITS = 24;         // the header's low bits count tickets, the rest calls

struct Params {
  const float* a;
  const float* x;
  float* h;
  unsigned long long* scratch;
  int B, S, W, tiles, chunks;
  long long a_sb, a_ss, x_sb, x_ss, h_sb, h_ss;   // strides in elements; W has stride 1
};

// Slot k of bank `bank` (the banks interleave, so a slot's place does not
// depend on the buffer's size).
__device__ __forceinline__ unsigned long long* slot_at(const Params& p, int bank, long long k) {
  return p.scratch + HEADER + (2 * k + bank) * SLOT;
}

// A (P, E) pair as one word that is never 0 (0 is an empty slot): the bits
// inverted, P's NaNs made the canonical one, so the pair is never all ones.
__device__ __forceinline__ unsigned long long encode(float P, float E) {
  if (P != P) P = __int_as_float(0x7fffffff);
  return ~(static_cast<unsigned long long>(__float_as_uint(E)) << 32 | __float_as_uint(P));
}
__device__ __forceinline__ float2 decode(unsigned long long word) {
  word = ~word;
  return make_float2(__uint_as_float(static_cast<unsigned>(word)),
                     __uint_as_float(static_cast<unsigned>(word >> 32)));
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) rg_lru_kernel(const Params p) {
  __shared__ float s_prod[WARPS][CH];     // each warp's product of a
  __shared__ float s_end[WARPS][CH];      // its end state from 0; then its entering state
  __shared__ long long s_local;
  __shared__ int s_bank;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per_chunk = p.B * p.tiles;
  const long long n = (long long)per_chunk * p.chunks;   // blocks

  long long local = blockIdx.x;
  int bank = 0;
  if (p.chunks > 1) {
    if (threadIdx.x == 0) {
      // one atomic gives the call's number (high bits) and the ticket (low);
      // the block with the last ticket turns the header to the next call's
      // and records how many slots this call's bank holds
      const unsigned long long got = atomicAdd(p.scratch, 1ull);
      const long long t = (long long)(got & ((1ull << COUNT_BITS) - 1));
      const int bk = (int)(got >> COUNT_BITS) & 1;
      if (t == n - 1) {
        atomicAdd(p.scratch, (1ull << COUNT_BITS) - n);
        st_relaxed_u64(p.scratch + 1 + bk, (unsigned long long)n);
      }
      s_local = t;
      s_bank = bk;
    }
    __syncthreads();
    local = s_local;
    bank = s_bank;
  }
  const int chunk = (int)(local / per_chunk);
  const int rem = (int)(local % per_chunk);
  const int b = rem / p.tiles, tile = rem % p.tiles;
  const long long row = (long long)rem * p.chunks;   // slot of this (batch, tile)'s chunk 0

  const int w = tile * CH + lane;
  const bool live = w < p.W;
  const int t0 = chunk * CHUNK + warp * ROWS;
  const float* ap = p.a + b * p.a_sb + (long long)t0 * p.a_ss + w;
  const float* xp = p.x + b * p.x_sb + (long long)t0 * p.x_ss + w;
  float av[ROWS], xv[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const bool in = live && t0 + r < p.S;
    av[r] = in ? ap[r * p.a_ss] : 1.f;
    xv[r] = in ? xp[r * p.x_ss] : 0.f;
  }

  float prod = 1.f, e = 0.f;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    e = fmaf(av[r], e, xv[r]);
    prod *= av[r];
  }
  s_prod[warp][lane] = prod;
  s_end[warp][lane] = e;
  __syncthreads();

  if (warp == 0) {
    float P = 1.f, E = 0.f;
    for (int v = 0; v < WARPS; ++v) {
      E = fmaf(s_prod[v][lane], E, s_end[v][lane]);
      P *= s_prod[v][lane];
    }
    const bool anchor = chunk % ANCHOR == 0, publishes = chunk + 1 < p.chunks;
    unsigned long long* mine = slot_at(p, bank, row + chunk) + lane;
    if (!anchor && publishes) st_relaxed_u64(mine, encode(P, E));
    float c = 0.f;   // the state entering the chunk
    if (chunk > 0) {
      const int g = (chunk - 1) / ANCHOR * ANCHOR, m = chunk - g;   // 1 .. ANCHOR slots
      const unsigned long long* first = slot_at(p, bank, row + g) + lane;
      // each lane waits for its own words: a word is written whole, so one
      // that is not 0 holds its pair
      unsigned long long word[ANCHOR];
      for (;;) {
        bool ready = true;
#pragma unroll
        for (int q = 0; q < ANCHOR; ++q)
          if (q < m) {
            word[q] = ld_relaxed_u64(first + 2 * q * SLOT);
            ready &= word[q] != 0;
          }
        if (ready) break;
      }
#pragma unroll
      for (int q = 0; q < ANCHOR; ++q)
        if (q < m) {
          const float2 v = decode(word[q]);
          c = fmaf(v.x, c, v.y);
        }
    }
    if (anchor && publishes) st_relaxed_u64(mine, encode(0.f, fmaf(P, c, E)));
    for (int v = 0; v < WARPS; ++v) {   // the state entering each warp, in order
      const float pv = s_prod[v][lane], ev = s_end[v][lane];
      s_end[v][lane] = c;
      c = fmaf(pv, c, ev);
    }
  }
  if (warp == 1 && p.chunks > 1) {
    // empty the other bank's slots that the last call on it used (no reader
    // is left: that call has ended); the next call on it finds them empty
    const long long used = (long long)ld_relaxed_u64(p.scratch + 1 + (bank ^ 1));
    for (long long k = local; k < used; k += n) st_relaxed_u64(slot_at(p, bank ^ 1, k) + lane, 0ull);
  }
  __syncthreads();
  if (!live) return;

  float hv = s_end[warp][lane];
  float* hp = p.h + b * p.h_sb + (long long)t0 * p.h_ss + w;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    hv = fmaf(av[r], hv, xv[r]);
    if (t0 + r < p.S) hp[r * p.h_ss] = hv;
  }
}

}  // namespace

// a, x, h: (B, S, W) f32 through strides (the last dim contiguous); scratch:
// the stream's int64 buffer, HEADER + 2 * SLOT * (B * tiles * chunks) words at
// least, zeroed when it was made (`scratch_words` in rg_lru.py).  One launch.
// Returns 0 or a cudaError_t.
extern "C" int repro_rg_lru(const void* a, const void* x, void* h, void* scratch,
                            int B, int S, int W,
                            long long a_sb, long long a_ss,
                            long long x_sb, long long x_ss,
                            long long h_sb, long long h_ss, void* stream) {
  Params p;
  p.a = static_cast<const float*>(a);
  p.x = static_cast<const float*>(x);
  p.h = static_cast<float*>(h);
  p.scratch = static_cast<unsigned long long*>(scratch);
  p.B = B; p.S = S; p.W = W;
  p.tiles = (W + CH - 1) / CH;
  p.chunks = (S + CHUNK - 1) / CHUNK;
  p.a_sb = a_sb; p.a_ss = a_ss; p.x_sb = x_sb; p.x_ss = x_ss;
  p.h_sb = h_sb; p.h_ss = h_ss;
  const long long blocks = (long long)B * p.tiles * p.chunks;
  rg_lru_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// The kernel's geometry, for the wrapper's checks and the smoke test's report:
// rows of S per block, channels per tile, int64 words of header and per slot,
// threads per block, resident blocks per SM, and chunks per anchor.  Returns 0
// or a cudaError_t.
extern "C" int repro_rg_lru_info(int* out) {
  int per_sm = 0;
  const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, rg_lru_kernel, THREADS, 0);
  out[0] = CHUNK; out[1] = CH; out[2] = HEADER; out[3] = SLOT;
  out[4] = THREADS; out[5] = per_sm; out[6] = ANCHOR;
  return (int)rc;
}

extern "C" const char* repro_rg_lru_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
