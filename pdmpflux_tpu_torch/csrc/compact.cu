// K2: event-row compaction of a raw stream fill, over chain groups and row
// tiles.
//
// Replaces pdmpflux_tpu/ops/pallas/compact.py:compact_field (the Pallas
// log-shift kernel, d >= 128) and the XLA formulations it stands beside
// (core/engine.py: compact_stream_rows, compact_stream_rows_with_init,
// merge_stream_at_offsets).  The plain PyTorch version is compact_rows_plain
// in ops/cuda/compact.py.
//
// For chain b, the rows t of the fill with kind[t, b] > 0 are written, in
// time order, to output columns off[b] + j (j = their ordinal), for every
// field at once; columns from off[b] + (number kept) to W - 1 are zeroed;
// columns below off[b] are not touched (the accumulator of a merge); an
// optional init record goes to column 0.  Sources are read in the fill's
// (T, F, B) chain-minor layout (element (t, f, b) at t * row_stride +
// f * field_stride + b), so no transposing copy precedes the kernel; the
// output is the (B, W, F) skeleton layout.  A null source stands for rows
// of ones (the activity mask of a non-sticky fill).
//
// Design: four launches on the caller's stream, no allocation (the wrapper
// passes a scratch of (2 * n_tiles + 1) * B int32).
//  1. count_kernel: a warp reads one row of kind for 32 consecutive chains
//     (one 128-byte line) and walks the R rows of its row tile, building a
//     keep mask per (row tile, chain).
//  2. scan_kernel: per 32 chains, 32 warps split the row tiles into slices;
//     an exclusive scan of the masks' popcounts over the slices, then along
//     each slice, gives every (row tile, chain) its first output column,
//     off[b] plus the rows kept before the tile (clamped to W); one extra
//     row holds each chain's end column, where its zeroed tail begins.
//  3. copy_kernel, one CTA per (phase, row tile, chain group of 32): lane l
//     of every warp owns chain l of the group, so a load of element (t, f)
//     for the 32 chains is one line (two for 8-byte fields, one 32-byte
//     sector for the 1-byte activity stream), and only rows that chain
//     keeps are loaded.  The loads go by cp.async (no register per element;
//     the 1-byte stream through registers, 16 in flight) straight to the
//     chain's run in a 44 KB shared-memory stage, in output order: kept row
//     j of the tile (its rank, __popc of the mask below it) at j * FT.  The
//     store is then a plain copy of each run, warp by chain, consecutive
//     lanes on consecutive elements: one contiguous run of (kept x F)
//     elements of (B, W, F) when the segment is the whole field (d = 10),
//     rows of FT elements F apart otherwise.  Fields are cut into segments
//     of FT columns (all of a field where they fit the stage, else whole
//     32-byte sectors of its row) and packed into phases that fill the
//     stage; R is 32 rows when every field fits whole at 32 (d = 10 in
//     f32), else 16, else 8 (d = 1000: 40-column f32 segments, 160-column
//     activity segments).  Element sizes are template arguments; an
//     element's row in a split segment comes from a 32-bit multiply-high by
//     the segment's reciprocal, not a division.  The CTAs run phase
//     fastest, then row tile, so the CTAs in flight write each chain's runs
//     whole.
//  4. tail_kernel: the columns from each chain's end to W - 1 zeroed, field
//     by field as contiguous runs, in column parts spread over warps, and the
//     init record into column 0 (its only writer: the copy and the tail skip
//     column 0 of a field that has one).
//
// What bounds it on an H100: device-memory bytes.  Loads are whole lines
// across chains and stores are runs along a chain's rows, so the traffic is
// kind once and the masks, every (t, f) line in which at least one of the
// group's chains keeps its row, and the output written once.  The bound
// (chip_smoke.k2_bound) counts the kept rows only; a group reads a line in
// which only some chains keep, so at a keep share s the loads are about 1/s
// of their bound.  `python3 chip_ab.py --probe-k2` times the copy without
// its loads and without its stores (PERF.md holds the reading).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXF = 12;
constexpr int G = 32;               // chains per group: one lane each
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int STAGE = 45056;        // bytes of the shared-memory stage
constexpr int MAXP = 256;           // phases of one copy launch
constexpr int SCAN_SLICES = 32;
constexpr int TAIL_BYTES = 32768;   // output bytes of one tail part of a chain
constexpr int TAIL_CTAS = 132 * 16; // tail CTAs at most: a full H100, grid-strided
constexpr int MAX_GRID_Y = 65535;

struct Field {
  const char* src;     // null: every source element is 1
  long row_stride;     // elements between rows t and t + 1
  long field_stride;   // elements between columns f and f + 1 of a row
  int width;           // F
  int elem;            // bytes per element: 1, 4 or 8
  int seg;             // columns of one segment (all F where they fit the stage)
  const char* init;    // (B, F) record for column 0, or null
  char* out;           // (B, W, F)
};

struct Fields {
  Field f[MAXF];
  int n;
};

// The first segment of each phase of a launch, as (q << 24) | f0.
struct Phases {
  int start[MAXP];
  int n;
};

template <int E> struct Word;
template <> struct Word<1> { using T = uint8_t; };
template <> struct Word<4> { using T = uint32_t; };
template <> struct Word<8> { using T = uint64_t; };

// Elements of the stage one chain's run takes: R rows of nf columns and one
// more, so that the chains' runs start in different banks.
__host__ __device__ inline int chain_pitch(int R, int nf) { return R * nf + 1; }

// Rows per tile: 32 when every field's rows of a group fit the stage whole
// at 32 (d = 10 in f32), else 16, else 8.
int tile_rows(int n, const int* widths, const int* elems) {
  for (int R = 32; R > 8; R /= 2) {
    bool fits = true;
    for (int q = 0; q < n; ++q)
      fits = fits && (long)G * chain_pitch(R, widths[q]) * elems[q] <= STAGE;
    if (fits) return R;
  }
  return 8;
}

// Columns of one segment of a field: all of them if they fit the stage,
// else the most that fit, cut at whole 32-byte sectors of the row.
int segment_cols(int R, int width, int elem) {
  int ft = (STAGE / (G * elem) - 1) / R;
  if (ft >= width) return width;
  if (ft >= 32 / elem) ft -= ft % (32 / elem);
  return ft;
}

// floor(e / n) for 0 <= e < 32 * n, n <= STAGE: a multiply-high by
// ceil(2^32 / n) (exact while e * n < 2^32), e itself for n = 1.
struct Div {
  uint32_t n, m;
  __device__ explicit Div(uint32_t n_) : n(n_), m(n_ > 1 ? 0xFFFFFFFFu / n_ + 1u : 0u) {}
  __device__ __forceinline__ uint32_t operator()(uint32_t e) const {
    return n > 1 ? __umulhi(e, m) : e;
  }
};

// One segment: columns [f0, f0 + nf) of field q, and its stage bytes.
struct Seg {
  int q, f0, nf, bytes;
};

__host__ __device__ inline Seg segment(const Fields& fs, int R, int q, int f0) {
  const Field& f = fs.f[q];
  const int nf = f.seg < f.width - f0 ? f.seg : f.width - f0;
  // rows of ones stage nothing
  return Seg{q, f0, nf, f.src ? (G * chain_pitch(R, nf) * f.elem + 15) & ~15 : 0};
}

__host__ __device__ inline void advance(const Seg& s, const Fields& fs, int& q, int& f0) {
  f0 = s.f0 + s.nf;
  if (f0 >= fs.f[s.q].width) {
    ++q;
    f0 = 0;
  }
}

// Move (q, f0) past one phase: the consecutive segments that fit the stage
// together.
__host__ __device__ inline void next_phase(const Fields& fs, int R, int& q, int& f0) {
  int used = 0;
  while (q < fs.n) {
    const Seg sg = segment(fs, R, q, f0);
    if (used > 0 && used + sg.bytes > STAGE) break;
    used += sg.bytes;
    advance(sg, fs, q, f0);
  }
}

__global__ void __launch_bounds__(THREADS) count_kernel(
    const int* __restrict__ kind, long kind_row_stride, int T, int B, int R, int n_tiles,
    uint32_t* __restrict__ masks) {
  const long b = (long)blockIdx.x * G + (threadIdx.x & 31);
  if (b >= B) return;
  for (int tile = blockIdx.y * WARPS + (threadIdx.x >> 5); tile < n_tiles;
       tile += gridDim.y * WARPS) {
    const int t0 = tile * R, rows = min(R, T - t0);
    uint32_t m = 0;
#pragma unroll 8
    for (int r = 0; r < rows; ++r)
      m |= (uint32_t)(kind[(long)(t0 + r) * kind_row_stride + b] > 0) << r;
    masks[(long)tile * B + b] = m;
  }
}

__global__ void __launch_bounds__(G * SCAN_SLICES) scan_kernel(
    const uint32_t* __restrict__ masks, const int* __restrict__ off, int B, int n_tiles,
    int W, int* __restrict__ starts) {
  __shared__ int part[SCAN_SLICES][G];
  const int c = threadIdx.x & 31, s = threadIdx.x >> 5;
  const long b = (long)blockIdx.x * G + c;
  const int per = (n_tiles + SCAN_SLICES - 1) / SCAN_SLICES;
  const int lo = min(n_tiles, s * per), hi = min(n_tiles, lo + per);
  int sum = 0;
  if (b < B)
    for (int tile = lo; tile < hi; ++tile) sum += __popc(masks[(long)tile * B + b]);
  part[s][c] = sum;
  __syncthreads();
  if (b >= B) return;
  long col = off ? off[b] : 0;
  for (int k = 0; k < s; ++k) col += part[k][c];
  for (int tile = lo; tile < hi; ++tile) {
    starts[(long)tile * B + b] = (int)(col < W ? col : W);
    col += __popc(masks[(long)tile * B + b]);
  }
  if (s == SCAN_SLICES - 1) starts[(long)n_tiles * B + b] = (int)(col < W ? col : W);
}

// A global-to-shared copy that holds no register: cp.async (4 or 8 bytes).
template <typename V>
__device__ __forceinline__ void copy_async(V* dst, const V* src) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "n"(sizeof(V)));
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void wait_async() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// Stage the segment's kept rows in output order: lane l loads chain l's
// element (r, col), so a warp reads one line per (row, column), and puts it
// at its chain's run, position (rank of r) * nf + col.  Warp w takes rows
// w, w + 8, ... of the tile.
template <int E>
__device__ __forceinline__ void load_segment(const Field& f, const Seg& sg, char* stage,
                                             int R, int t0, long b, uint32_t mask) {
  using V = typename Word<E>::T;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const V* src = (const V*)f.src + (long)t0 * f.row_stride + (long)sg.f0 * f.field_stride + b;
  V* run = (V*)stage + lane * chain_pitch(R, sg.nf);
  for (int r = warp; r < R; r += WARPS) {
    if (!((mask >> r) & 1u)) continue;
    V* d = run + __popc(mask & ((1u << r) - 1u)) * sg.nf;
    const V* s = src + r * f.row_stride;
    if constexpr (E > 1) {
      for (int col = 0; col < sg.nf; ++col) copy_async(d + col, s + col * f.field_stride);
    } else {
      constexpr int U = 16;  // 1-byte elements go through registers, 16 in flight
      for (int c0 = 0; c0 < sg.nf; c0 += U) {
        V v[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (c0 + u < sg.nf) v[u] = s[(c0 + u) * f.field_stride];
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (c0 + u < sg.nf) d[c0 + u] = v[u];
      }
    }
  }
}

// Write each chain's staged run, warp by chain, consecutive lanes on
// consecutive elements: one contiguous run of (kept x F) elements when the
// segment is the whole field, else rows of nf elements F apart.
template <int E>
__device__ __forceinline__ void store_segment(const Field& f, const Seg& sg,
                                              const char* stage, int R, long b0, int nc, int W,
                                              const int* cnt, const int* start) {
  using V = typename Word<E>::T;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Div div(sg.nf);
  const int gap = f.width - sg.nf;
  for (int c = warp; c < nc; c += WARPS) {
    const long col0 = start[c];
    const int kept = (int)min((long)cnt[c], W - col0);
    if (kept <= 0) continue;
    const V* run = (const V*)stage + c * chain_pitch(R, sg.nf);
    V* dst = (V*)f.out + ((b0 + c) * W + col0) * f.width + sg.f0;
    const int first = (f.init && col0 == 0) ? sg.nf : 0;  // column 0 is the init's
    const int n = kept * sg.nf;
    if (gap == 0) {
      for (int e = first + lane; e < n; e += 32) dst[e] = f.src ? run[e] : (V)1;
    } else {
      for (int e = first + lane; e < n; e += 32)
        dst[e + (long)div(e) * gap] = f.src ? run[e] : (V)1;
    }
  }
}

// One CTA per (phase, row tile, chain group), in that order from the
// fastest: the CTAs in flight write whole runs of each chain's rows.
__global__ void __launch_bounds__(THREADS, 4) copy_kernel(
    const uint32_t* __restrict__ masks, const int* __restrict__ starts, int B, int R,
    int n_tiles, int W, Fields fs, Phases ph) {
  __shared__ __align__(16) char stage[STAGE];
  __shared__ int cnt[G], start[G];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long L = blockIdx.x / ph.n;
  const int phase = blockIdx.x - (int)(L * ph.n);
  const int tile = (int)(L % n_tiles);
  const long b0 = L / n_tiles * G;
  const int nc = (int)min((long)G, B - b0);
  const uint32_t mask = lane < nc ? masks[(long)tile * B + b0 + lane] : 0u;
  // every warp holds the group's 32 masks, so the test is block-uniform
  if (!__any_sync(0xffffffffu, mask != 0u)) return;
  if (warp == 0) {
    cnt[lane] = __popc(mask);
    start[lane] = lane < nc ? starts[(long)tile * B + b0 + lane] : W;
  }
  const int q0 = ph.start[phase] >> 24, f00 = ph.start[phase] & 0xffffff;
  int q1 = q0, f1 = f00;  // the phase: segments from (q0, f00) to (q1, f1)
  next_phase(fs, R, q1, f1);
  int used = 0;
  for (int q = q0, f0 = f00; q < q1 || (q == q1 && f0 < f1);) {
    const Seg sg = segment(fs, R, q, f0);
    const Field& f = fs.f[q];
    if (f.src) {
      if (f.elem == 4) load_segment<4>(f, sg, stage + used, R, tile * R, b0 + lane, mask);
      else if (f.elem == 8) load_segment<8>(f, sg, stage + used, R, tile * R, b0 + lane, mask);
      else load_segment<1>(f, sg, stage + used, R, tile * R, b0 + lane, mask);
    }
    used += sg.bytes;
    advance(sg, fs, q, f0);
  }
  wait_async();
  __syncthreads();  // the stage, counts and starts are in place
  used = 0;
  for (int q = q0, f0 = f00; q < q1 || (q == q1 && f0 < f1);) {
    const Seg sg = segment(fs, R, q, f0);
    const Field& f = fs.f[q];
    if (f.elem == 4) store_segment<4>(f, sg, stage + used, R, b0, nc, W, cnt, start);
    else if (f.elem == 8) store_segment<8>(f, sg, stage + used, R, b0, nc, W, cnt, start);
    else store_segment<1>(f, sg, stage + used, R, b0, nc, W, cnt, start);
    used += sg.bytes;
    advance(sg, fs, q, f0);
  }
}

template <int E>
__device__ __forceinline__ void tail_field(const Field& f, long b, long lo, long hi, int W,
                                           bool first_part, int lane) {
  using V = typename Word<E>::T;
  V* out = (V*)f.out;
  const long F = f.width;
  if (f.init && lo < 1) lo = 1;  // column 0 is the init's
  for (long e = lo * F + lane; e < hi * F; e += 32) out[b * W * F + e] = (V)0;
  if (first_part && f.init && W > 0)
    for (int j = lane; j < F; j += 32) out[b * W * F + j] = ((const V*)f.init)[b * F + j];
}

__global__ void __launch_bounds__(THREADS) tail_kernel(const int* __restrict__ ends, int B,
                                                       int W, int part_cols, int parts,
                                                       Fields fs) {
  const int lane = threadIdx.x & 31;
  const long n_items = (long)B * parts;
  const long stride = (long)gridDim.x * WARPS;
  for (long i = (long)blockIdx.x * WARPS + (threadIdx.x >> 5); i < n_items; i += stride) {
    const long b = i % B, k = i / B;
    const long lo = ends[b] + k * part_cols;
    const bool first = k == 0;
    if (lo >= W && !first) continue;
    const long hi = lo + part_cols < W ? lo + part_cols : W;
    for (int q = 0; q < fs.n; ++q) {
      const Field& f = fs.f[q];
      if (f.elem == 4) tail_field<4>(f, b, lo, hi, W, first, lane);
      else if (f.elem == 8) tail_field<8>(f, b, lo, hi, W, first, lane);
      else tail_field<1>(f, b, lo, hi, W, first, lane);
    }
  }
}

long n_tiles_of(int T, int R) { return (T + R - 1) / R; }

}  // namespace

// int32 words of scratch compact_rows_launch needs: a keep mask and a start
// column per (row tile, chain), and each chain's end column.
extern "C" long compact_rows_scratch(int T, int B, int n_fields, const int* widths,
                                     const int* elems) {
  if (n_fields < 1 || n_fields > MAXF || T < 0 || B < 1) return -1;
  return (2 * n_tiles_of(T, tile_rows(n_fields, widths, elems)) + 1) * (long)B;
}

extern "C" int compact_rows_launch(const void* kind, long kind_row_stride, int T, int B,
                                   const void* off, int W, int n_fields,
                                   const void* const* srcs, const long* row_strides,
                                   const long* field_strides, const int* widths,
                                   const int* elems, const void* const* inits,
                                   void* const* outs, void* scratch, long scratch_words,
                                   void* stream) {
  if (n_fields < 1 || n_fields > MAXF || B < 1 || T < 0 || W < 0)
    return (int)cudaErrorInvalidValue;
  for (int q = 0; q < n_fields; ++q)
    if ((elems[q] != 1 && elems[q] != 4 && elems[q] != 8) || widths[q] < 1 ||
        widths[q] > 0xffffff)
      return (int)cudaErrorInvalidValue;
  const int R = tile_rows(n_fields, widths, elems);
  Fields fs;
  fs.n = n_fields;
  for (int q = 0; q < n_fields; ++q)
    fs.f[q] = Field{(const char*)srcs[q], row_strides[q], field_strides[q], widths[q],
                    elems[q], segment_cols(R, widths[q], elems[q]), (const char*)inits[q],
                    (char*)outs[q]};
  const long n_tiles = n_tiles_of(T, R);
  if (scratch_words < (2 * n_tiles + 1) * (long)B || n_tiles > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  if (W == 0) return 0;  // no column to write
  uint32_t* masks = (uint32_t*)scratch;
  int* starts = (int*)scratch + n_tiles * B;
  const int* ends = starts + n_tiles * B;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned groups = (unsigned)((B + G - 1) / G);
  cudaGetLastError();  // clear a stale error so the checks below are this call's
  int err;
  if (n_tiles > 0) {
    const long ys = (n_tiles + WARPS - 1) / WARPS;
    count_kernel<<<dim3(groups, (unsigned)(ys < MAX_GRID_Y ? ys : MAX_GRID_Y)), THREADS, 0, s>>>(
        (const int*)kind, kind_row_stride, T, B, R, (int)n_tiles, masks);
    if ((err = (int)cudaGetLastError())) return err;
  }
  scan_kernel<<<groups, G * SCAN_SLICES, 0, s>>>(masks, (const int*)off, B, (int)n_tiles, W,
                                                  starts);
  if ((err = (int)cudaGetLastError())) return err;
  // the copy, in launches of at most MAXP phases
  for (int q = 0, f0 = 0; n_tiles > 0 && q < n_fields;) {
    Phases ph;
    for (ph.n = 0; ph.n < MAXP && q < n_fields; ++ph.n) {
      ph.start[ph.n] = (q << 24) | f0;
      next_phase(fs, R, q, f0);
    }
    const long blocks = ph.n * n_tiles * (long)groups;
    if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
    copy_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(masks, starts, B, R, (int)n_tiles, W, fs,
                                                      ph);
    if ((err = (int)cudaGetLastError())) return err;
  }
  long row_bytes = 0;
  for (int q = 0; q < n_fields; ++q) row_bytes += (long)widths[q] * elems[q];
  const long part_cols = TAIL_BYTES / row_bytes > 1 ? TAIL_BYTES / row_bytes : 1;
  const long parts = (W + part_cols - 1) / part_cols;
  const long blocks = ((long)B * parts + WARPS - 1) / WARPS;
  tail_kernel<<<(unsigned)(blocks < TAIL_CTAS ? blocks : TAIL_CTAS), THREADS, 0, s>>>(
      ends, B, W, (int)part_cols, (int)parts, fs);
  return (int)cudaGetLastError();
}
