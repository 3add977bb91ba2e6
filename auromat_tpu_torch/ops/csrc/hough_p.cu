// OpenCV's probabilistic Hough transform (cv2.HoughLinesP) for sm_90a.
//
// Replaces no TPU kernel: the JAX package calls cv2.HoughLinesP on the
// host (auromat_tpu/solving/masking.py::mask_starfield). Plain version:
// auromat_tpu_torch/solving/masking.py::_hough_p_plain, in the same
// arithmetic, so the two give the same lines in the same order and the
// same trajectory counts (voters, triggers, clearing steps, lines).
//
// The algorithm is sequential: each set pixel, in a fixed pseudo-random
// order (ops/csrc/hough_order.cu), votes into the accumulator, and a vote
// that reaches the threshold walks the line, clears its pixels from the
// mask and (for a line long enough to keep) takes their votes back, which
// changes what every later pixel sees. So one block walks the order, and
// the design takes the dependent steps off the critical path:
//   - windows of live candidates: the order is staged CHUNK at a time in
//     shared memory; every thread reads the mask byte of one of the next
//     THREADS candidates at once, and a ballot and a prefix compact the
//     live ones, up to WMAX in visit order. A candidate
//     cleared before its turn costs no dependent step;
//   - the window's values, read once: thread n owns angle n's accumulator
//     row. It computes the window's bins, starts their reads together and
//     keeps in registers v[i], the value candidate i's vote gives its bin
//     if every earlier candidate of the window votes (a same-bin run adds
//     one per earlier candidate), and the bit mask of the candidates whose
//     v reaches the threshold;
//   - the triggers inside the window, one after another without reading
//     the accumulator again: each thread's first candidate still to vote
//     with its bit set, one block reduction (redux.sync, then the six
//     warps) of (WMAX - first) << 24 | votes << 8 | 255 - n gives j*, the
//     first trigger in visit order, and at j* the first maximum over the
//     angles (a tie keeps the smallest n; only angles that reach the
//     threshold at j* can hold the maximum; votes < 2^16, the wrapper's
//     guard). The candidates up to j* vote: fire-and-forget atomics, each
//     thread on its own row. A candidate the walk clears adds nothing to
//     the later ones' v; a kept line's take-back makes the threads read
//     the rest of the window again. Without a trigger the rest votes;
//   - the walks, 32 positions a round trip: lane t of warp k reads
//     position s + t of direction k (warps 0 and 1 at once), at the 16-bit
//     fixed-point point x0 + (s + t) dx0, the same integers as OpenCV's
//     repeated adds. A ballot of the in-bounds and set bits, each lane's
//     unset run (carried across rounds), and a ballot of the lanes that
//     end the walk (out of bounds, or a run past max_line_gap) give the
//     end: the last set position before it. The set bits are kept;
//   - the clearing: one parallel pass over the kept bits up to each end
//     (the seed is cleared by direction 0 only), stores without reads.
//     Which of the window's candidates it cleared follows from their
//     coordinates (set, and on the path between the two ends). For a kept
//     line the cleared pixels go to a list (at most 2 (w + h)); after a
//     __syncthreads every thread takes back its angle's votes of it.
// What bounds it: latency. A window costs two L2 round trips (its mask
// bytes, its accumulator values) and two barriers; a trigger one round
// trip a 32 positions of walk, two barriers and a few hundred dependent
// instructions of one warp. The accumulator (numangle x numrho int32, 10.2
// MB at 4256x2832) and the mask (12 MB) stay in the 50 MB L2. The bytes it
// must move (the order, the mask, the lines) take ~0.01 ms at 3.35 TB/s.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 192;  // >= numangle (180 at theta = pi/180)
constexpr int WARPS = THREADS / 32;
constexpr int WMAX = 16;      // candidates a window at most
constexpr int CHUNK = 4096;   // staged candidates
constexpr int MAXR = 512;     // walk rounds a direction: sides up to 16383
constexpr int SHIFT = 16;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int vote_bin(int x, int y, float c, float s) {
  return __float2int_rn(__fadd_rn(__fmul_rn((float)x, c), __fmul_rn((float)y, s)));
}

__device__ __forceinline__ unsigned lanes_below(int lane) { return (1u << lane) - 1u; }

// thread n adds angle n's votes of the window candidates in `bits`
// (fire-and-forget atomics on its own row)
__device__ __forceinline__ void commit(int* row, const int* s_win, unsigned bits, float c,
                                       float s) {
  for (; bits; bits &= bits - 1) {
    const int q = s_win[__ffs(bits) - 1];
    atomicAdd(row + vote_bin(q & 0xffff, q >> 16, c, s), 1);
  }
}

// the candidates whose vote would reach the threshold
__device__ __forceinline__ unsigned hot_mask(const int* v, int nw, int threshold) {
  unsigned hot = 0;
#pragma unroll
  for (int i = 0; i < WMAX; ++i) {
    if (i >= nw) break;
    hot |= (unsigned)(v[i] >= threshold) << i;
  }
  return hot;
}

// v[i] (i in `todo`) = v[i] + 1 + the candidates of `todo` before i in
// the same bin
__device__ __forceinline__ void same_bin_runs(const int* bins, int* v, int nw, unsigned todo) {
#pragma unroll
  for (int i = 0; i < WMAX; ++i) {
    if (i >= nw) break;
    int d = 1;
#pragma unroll
    for (int i2 = 0; i2 < i; ++i2) d += ((todo >> i2) & 1u) && bins[i2] == bins[i];
    v[i] += d;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
hough_p_kernel(const int* __restrict__ pts, int count, unsigned char* mask,
               int width, int height, int* acc, int numangle, int numrho,
               const float* __restrict__ trig, int threshold, int line_length,
               int line_gap, int* lines, int* list, long long* stats) {
  __shared__ float s_cos[THREADS], s_sin[THREADS];
  __shared__ int s_pt[CHUNK];  // y << 16 | x
  __shared__ int s_win[WMAX], s_wpos[WMAX];
  __shared__ int s_cnt[WARPS];
  __shared__ unsigned s_key[WARPS];
  __shared__ unsigned s_bal[2][MAXR];
  __shared__ int s_end[2][3];  // x, y, position of each direction's end
  __shared__ int s_nlist;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int half = (numrho - 1) / 2;
  if (tid < numangle) {
    s_cos[tid] = trig[tid];
    s_sin[tid] = trig[numangle + tid];
  }
  int* row = acc + (size_t)min(tid, numangle - 1) * numrho + half;
  const float cn = trig[min(tid, numangle - 1)], sn = trig[numangle + min(tid, numangle - 1)];
  long long voters = 0, triggers = 0, csteps = 0;
  int nl = 0;

  for (int base = 0; base < count; base += CHUNK) {
    const int m = min(CHUNK, count - base);
    __syncthreads();  // the previous chunk is read by everyone
    for (int i = tid; i < m; i += THREADS)
      s_pt[i] = (pts[2 * (base + i) + 1] << 16) | pts[2 * (base + i)];
    __syncthreads();
    int cur = 0;
    while (cur < m) {
      // -- a window: the live candidates among the next THREADS ----------
      const int p = cur + tid;
      bool live = false;
      int pt = 0;
      if (p < m) {
        pt = s_pt[p];
        live = __ldcg(mask + (size_t)(pt >> 16) * width + (pt & 0xffff)) != 0;
      }
      const unsigned bl = __ballot_sync(FULL, live);
      if (lane == 0) s_cnt[warp] = __popc(bl);
      __syncthreads();
      int before = 0, total = 0;
      for (int w = 0; w < WARPS; ++w) {
        before += w < warp ? s_cnt[w] : 0;
        total += s_cnt[w];
      }
      const int rank = before + __popc(bl & lanes_below(lane));
      if (live && rank < WMAX) {
        s_win[rank] = pt;
        s_wpos[rank] = p;
      }
      const int nw = min(total, WMAX);
      __syncthreads();
      const int next = total >= WMAX ? s_wpos[WMAX - 1] + 1 : min(cur + THREADS, m);
      cur = next;
      if (nw == 0) continue;  // uniform over the block

      // -- the window's values: thread n, angle n -------------------------
      // v[i]: what candidate i's vote makes of its bin, if every candidate
      // of the window before it votes (its read value, plus one, plus one
      // for each earlier candidate in the same bin)
      int bins[WMAX], v[WMAX];
      unsigned todo = (1u << nw) - 1u;  // still to vote
      unsigned hot = 0;  // candidates whose vote reaches the threshold
      if (tid < numangle) {
#pragma unroll
        for (int i = 0; i < WMAX; ++i) {
          if (i >= nw) break;
          const int q = s_win[i];
          bins[i] = vote_bin(q & 0xffff, q >> 16, cn, sn);
          v[i] = __ldcg(row + bins[i]);
        }
        same_bin_runs(bins, v, nw, todo);  // while the reads are in flight
        hot = hot_mask(v, nw, threshold);
      }
      while (todo) {
        // the first candidate still to vote whose vote reaches the
        // threshold, and at it the first maximum over the angles: a key of
        // (WMAX - first) << 24 | votes << 8 | 255 - n (votes < 2^16)
        unsigned key = 0;
        if (hot & todo) {
          const int first = __ffs(hot & todo) - 1;
          int vfirst = 0;
#pragma unroll
          for (int i = 0; i < WMAX; ++i) vfirst = i == first ? v[i] : vfirst;
          key = (unsigned)(WMAX - first) << 24 | (unsigned)vfirst << 8 | (unsigned)(255 - tid);
        }
        key = __reduce_max_sync(FULL, key);
        if (lane == 0) s_key[warp] = key;
        __syncthreads();
        unsigned best = s_key[0];
        for (int w = 1; w < WARPS; ++w) best = max(best, s_key[w]);
        if (!best) {  // no trigger: the rest of the window votes
          if (tid < numangle) commit(row, s_win, todo, cn, sn);
          voters += __popc(todo);
          break;
        }

        // -- a trigger: walk from candidate j* along the first maximum ----
        const int js = WMAX - (int)(best >> 24);
        const unsigned voted = todo & (js == 31 ? FULL : (2u << js) - 1u);
        todo &= ~voted;
        voters += __popc(voted);
        ++triggers;
        const int n = 255 - (int)(best & 255);
        const int seed = s_win[js];
        const float fa = -s_sin[n], fb = s_cos[n];
        const float one = (float)(1 << SHIFT);
        const bool xflag = fabsf(fa) > fabsf(fb);
        long long x0 = seed & 0xffff, y0 = seed >> 16;
        int dx0, dy0;
        if (xflag) {
          dx0 = fa > 0 ? 1 : -1;
          dy0 = __float2int_rn(__fdiv_rn(__fmul_rn(fb, one), fabsf(fa)));
          y0 = (y0 << SHIFT) + (1 << (SHIFT - 1));
        } else {
          dy0 = fb > 0 ? 1 : -1;
          dx0 = __float2int_rn(__fdiv_rn(__fmul_rn(fa, one), fabsf(fb)));
          x0 = (x0 << SHIFT) + (1 << (SHIFT - 1));
        }
        if (tid == 0) s_nlist = 0;
        if (warp < 2) {  // the gap-limited walk of direction `warp`
          const int k = warp;
          const long long dx = k ? -dx0 : dx0, dy = k ? -dy0 : dy0;
          int carry = 0, last = -1;
          for (int r = 0;; ++r) {
            const long long s = (long long)r * 32 + lane;
            const long long px = x0 + s * dx, py = y0 + s * dy;
            const long long j1 = xflag ? px : px >> SHIFT, i1 = xflag ? py >> SHIFT : py;
            const bool inb = j1 >= 0 && j1 < width && i1 >= 0 && i1 < height;
            const bool set = inb && __ldcg(mask + (size_t)i1 * width + j1) != 0;
            const unsigned bs = __ballot_sync(FULL, set);
            if (lane == 0 && r < MAXR) s_bal[k][r] = bs;
            const unsigned low = bs & (FULL >> (31 - lane));  // lanes <= this one
            const int run = low ? __clz(low) - (31 - lane) : lane + 1 + carry;
            const unsigned term = __ballot_sync(FULL, !inb || run > line_gap);
            if (term) {
              const unsigned lb = bs & lanes_below(__ffs(term) - 1);
              if (lb) last = r * 32 + 31 - __clz(lb);
              break;
            }
            if (bs) {
              last = r * 32 + 31 - __clz(bs);
              carry = __clz(bs);
            } else {
              carry += 32;
            }
          }
          if (lane == 0) {  // last >= 0: the seed is set
            const long long px = x0 + last * dx, py = y0 + last * dy;
            s_end[k][0] = (int)(xflag ? px : px >> SHIFT);
            s_end[k][1] = (int)(xflag ? py >> SHIFT : py);
            s_end[k][2] = last;
          }
        }
        if (tid < numangle) commit(row, s_win, voted, cn, sn);  // after the walk's reads
        __syncthreads();
        const int ex0 = s_end[0][0], ey0 = s_end[0][1], ex1 = s_end[1][0], ey1 = s_end[1][1];
        const bool good = abs(ex1 - ex0) >= line_length || abs(ey1 - ey0) >= line_length;
        const int end0 = s_end[0][2], end1 = s_end[1][2];
        csteps += end0 + end1 + 2;
        if (warp < 2) {  // clear direction `warp` up to its end, from the kept bits
          const int k = warp, end = k ? end1 : end0;
          const long long dx = k ? -dx0 : dx0, dy = k ? -dy0 : dy0;
          for (int r = 0; r * 32 <= end; ++r) {
            const int s = r * 32 + lane;
            const bool bit = s <= end && ((s_bal[k][r] >> lane) & 1u) && !(k == 1 && s == 0);
            const long long px = x0 + s * dx, py = y0 + s * dy;
            const int j1 = (int)(xflag ? px : px >> SHIFT), i1 = (int)(xflag ? py >> SHIFT : py);
            if (bit) mask[(size_t)i1 * width + j1] = 0;
            if (good) {
              const unsigned bb = __ballot_sync(FULL, bit);
              int at = 0;
              if (lane == 0 && bb) at = atomicAdd(&s_nlist, __popc(bb));
              at = __shfl_sync(FULL, at, 0);
              if (bit) list[at + __popc(bb & lanes_below(lane))] = (i1 << 16) | j1;
            }
          }
        }
        // the window's candidates this walk cleared (each warp finds them:
        // set, so cleared if on the path between the two ends)
        bool gone = false;
        if (lane < nw && ((todo >> lane) & 1u)) {
          const int q = s_win[lane], x = q & 0xffff, y = q >> 16;
          const long long sv = xflag ? (x - x0) * dx0 : (y - y0) * dy0;
          gone = sv >= -end1 && sv <= end0 &&
                 (xflag ? (y0 + sv * dy0) >> SHIFT : (x0 + sv * dx0) >> SHIFT) == (xflag ? y : x);
        }
        const unsigned cleared = __ballot_sync(FULL, gone);
        todo &= ~cleared;
        if (cleared && tid < numangle) {  // they add no vote to later ones
          for (unsigned left = cleared; left; left &= left - 1) {
            const int c = __ffs(left) - 1, q = s_win[c];
            const int bc = vote_bin(q & 0xffff, q >> 16, cn, sn);
#pragma unroll
            for (int i = 0; i < WMAX; ++i) v[i] -= i > c && bins[i] == bc;
          }
          hot = hot_mask(v, nw, threshold);
        }
        if (good) {
          __syncthreads();  // the list is complete
          if (tid < numangle) {  // take back the cleared pixels' votes
            const int len = s_nlist;
            for (int q = 0; q < len; ++q) {
              const int e = list[q];
              atomicSub(row + vote_bin(e & 0xffff, e >> 16, cn, sn), 1);
            }
#pragma unroll
            for (int i = 0; i < WMAX; ++i) {  // re-read what the rest sees
              if (i >= nw) break;
              if ((todo >> i) & 1u) v[i] = __ldcg(row + bins[i]);
            }
            same_bin_runs(bins, v, nw, todo);
            hot = hot_mask(v, nw, threshold);
          }
          if (tid == 0) reinterpret_cast<int4*>(lines)[nl] = make_int4(ex0, ey0, ex1, ey1);
          ++nl;
        }
      }
      __syncthreads();  // the window's clearing is seen by the next mask reads
    }
  }
  if (tid == 0) {
    stats[0] = voters;
    stats[1] = triggers;
    stats[2] = csteps;
    stats[3] = nl;
  }
}

}  // namespace

extern "C" int hough_p_launch(const int* pts, int count, unsigned char* mask,
                              int width, int height, int* acc, int numangle,
                              int numrho, const float* trig, int threshold,
                              int line_length, int line_gap, int* lines,
                              int* list, long long* stats, void* stream) {
  if (numangle < 1 || numangle > THREADS ||
      width < 1 || height < 1 || width > MAXR * 32 - 1 || height > MAXR * 32 - 1)
    return (int)cudaErrorInvalidValue;
  hough_p_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(
      pts, count, mask, width, height, acc, numangle, numrho, trig, threshold,
      line_length, line_gap, lines, list, stats);
  return (int)cudaGetLastError();
}
