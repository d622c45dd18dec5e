// Measured-local scalar CPU baseline for the bench workspace.
//
// The reference compares against external CPU crates (QueueIgor /
// RescanDaniel, /root/reference/bench/src/bin/paper.rs external()).
// Those Rust crates cannot be rebuilt in this environment, so their
// numbers are carried from the reference's committed results. This file
// provides the missing *measured-on-this-host* analog: a single-core
// scalar C++ implementation of the exact framework semantics
// (ops/oracle.py is the contract), timed on the host of the accelerator
// whose numbers are measured.
//
// Semantics (bit-identical to ops/oracle.py, differential-tested by
// tests/test_cpu_scalar.py):
//   - rolling 32-bit hash  h_fwd(i) = XOR_j rotl32(T[c[i+j]], (j+23)%32)
//     with T the 4-entry table supplied by the caller (NT_TABLE or the
//     MulHasher-derived table; hashers/__init__.py).
//   - canonical hash = h_fwd ^ h_rc with
//     h_rc(i) = XOR_j rotl32(T[c[i+k-1-j] ^ 2], (j+23)%32).
//   - window minima compare the TOP 16 BITS only; forward picks the
//     leftmost minimum, canonical picks leftmost iff the l=w+k-1 window
//     has a strict majority of T/G chars, else rightmost
//     (/root/reference/src/sliding_min.rs:104-106, canonical.rs:12-31).
//   - adjacent equal positions are deduplicated.
//
// Algorithms mirror the reference bench zoo (bench/src/{queue,rescan,
// naive}.rs analogs; see bench/algs.py for the instrumented versions):
//   alg 0 = monotone deque ("queue")
//   alg 1 = keep-min + rescan-on-expiry ("rescan")
//   alg 2 = per-window rescan ("naive", O(n*w))
// Canonical mode needs both tie biases and is implemented for the
// queue algorithm (two deques, leftmost + rightmost).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline uint32_t rotl32(uint32_t x, int r) {
  r &= 31;
  return r ? (x << r) | (x >> (32 - r)) : x;
}

constexpr uint32_t VAL_MASK = 0xFFFF0000u;
constexpr int ROT = 23;  // global rotation offset (hashers/__init__.py)

// Rolling forward/rc hash state over a 2-bit code stream.
struct RollHash {
  const uint8_t* c;
  int k;
  const uint32_t* T;
  bool canonical;
  uint32_t hf = 0, hr = 0;

  void init() {
    hf = 0;
    hr = 0;
    for (int j = 0; j < k; ++j) {
      hf ^= rotl32(T[c[j] & 3], j + ROT);
      if (canonical) hr ^= rotl32(T[(c[k - 1 - j] & 3) ^ 2], j + ROT);
    }
  }

  // advance from kmer i to kmer i+1 (chars c[i] out, c[i+k] in)
  inline void step(int64_t i) {
    uint32_t out_f = rotl32(T[c[i] & 3], ROT);
    uint32_t in_f = rotl32(T[c[i + k] & 3], k - 1 + ROT);
    hf = rotl32(hf ^ out_f, 31) ^ in_f;  // rotr by 1
    if (canonical) {
      uint32_t out_r = rotl32(T[(c[i] & 3) ^ 2], k + ROT);
      uint32_t in_r = rotl32(T[(c[i + k] & 3) ^ 2], ROT);
      hr = rotl32(hr, 1) ^ out_r ^ in_r;
    }
  }

  inline uint32_t val() const {
    return (canonical ? (hf ^ hr) : hf) & VAL_MASK;
  }
};

// Monotone ring-buffer deque of (pos, val).
struct Deque {
  std::vector<int64_t> pos;
  std::vector<uint32_t> val;
  size_t head = 0, tail = 0, cap;
  explicit Deque(int w) : pos(w + 1), val(w + 1), cap(w + 1) {}
  inline bool empty() const { return head == tail; }
  inline void push_back(int64_t p, uint32_t v) {
    pos[tail] = p;
    val[tail] = v;
    tail = tail + 1 == cap ? 0 : tail + 1;
  }
  inline void pop_back() { tail = tail == 0 ? cap - 1 : tail - 1; }
  inline void pop_front() { head = head + 1 == cap ? 0 : head + 1; }
  inline int64_t front_pos() const { return pos[head]; }
  inline uint32_t back_val() const {
    return val[tail == 0 ? cap - 1 : tail - 1];
  }
};

inline int64_t dedup_emit(uint32_t* out, int64_t cnt, uint32_t p) {
  if (cnt == 0 || out[cnt - 1] != p) out[cnt++] = p;
  return cnt;
}

}  // namespace

extern "C" {

// Dedup'd minimizer positions of every w-window of k-mers of codes[0..n).
// table4: 4-entry uint32 hash table. out: caller buffer (>= nw entries).
// Returns the number of positions written, or -1 on bad arguments.
int64_t scalar_minimizers(const uint8_t* codes, int64_t n, int32_t k,
                          int32_t w, int32_t canonical, int32_t alg,
                          const uint32_t* table4, uint32_t* out) {
  if (k < 1 || w < 1) return -1;
  const int64_t l = (int64_t)k + w - 1;
  const int64_t nw = n - l + 1;
  if (nw <= 0) return 0;
  if (canonical && (l % 2) == 0) return -1;
  if (canonical && alg != 0) return -1;  // canonical: queue only

  RollHash rh{codes, k, table4, canonical != 0};
  rh.init();
  int64_t cnt = 0;

  if (alg == 0) {
    Deque L(w), R(w);  // leftmost-biased and rightmost-biased minima
    // rolling T/G majority count over the l-char window
    int64_t tg = 0;
    for (int64_t j = 0; j + 1 < k; ++j) tg += (codes[j] >> 1) & 1;
    const int64_t nk = n - k + 1;
    for (int64_t p = 0; p < nk; ++p) {
      if (p) rh.step(p - 1);
      const uint32_t v = rh.val();
      while (!L.empty() && v < L.back_val()) L.pop_back();
      L.push_back(p, v);
      if (canonical) {
        while (!R.empty() && v <= R.back_val()) R.pop_back();
        R.push_back(p, v);
      }
      tg += (codes[p + k - 1] >> 1) & 1;
      if (p >= w) tg -= (codes[p - w] >> 1) & 1;
      if (p >= w - 1) {
        const int64_t t = p - w + 1;
        if (L.front_pos() < t) L.pop_front();
        uint32_t sel;
        if (canonical) {
          if (R.front_pos() < t) R.pop_front();
          sel = (uint32_t)(2 * tg > l ? L.front_pos() : R.front_pos());
        } else {
          sel = (uint32_t)L.front_pos();
        }
        cnt = dedup_emit(out, cnt, sel);
      }
    }
    return cnt;
  }

  // rescan / naive (forward only): ring buffer of the last w values
  std::vector<uint32_t> ring(w);
  int64_t bp = -1;  // current best (leftmost-min) kmer index
  const int64_t nk = n - k + 1;
  for (int64_t p = 0; p < nk; ++p) {
    if (p) rh.step(p - 1);
    ring[p % w] = rh.val();
    if (p < w - 1) continue;
    const int64_t t = p - w + 1;
    if (alg == 2 || bp < t) {  // naive always rescans; rescan on expiry
      bp = t;
      for (int64_t j = t + 1; j <= p; ++j)
        if (ring[j % w] < ring[bp % w]) bp = j;
    } else if (ring[p % w] < ring[bp % w]) {
      bp = p;
    }
    cnt = dedup_emit(out, cnt, (uint32_t)bp);
  }
  return cnt;
}

}  // extern "C"
