// Native sequence ingestion: ASCII -> 2-bit packing and FASTA scanning.
//
// The reference's sequence layer (packed-seq) is SIMD Rust; this is the
// framework's host-side equivalent: a small C++ library (built with
// -O3 -march=native, auto-vectorized) doing the byte-level work that
// would bottleneck single-core Python. The device never sees ASCII.
//
// Code mapping (A=00, C=01, T=10, G=11 via (c>>1)&3, both cases), matching
// /root/reference/src/lib.rs:121-128 and seq/packed.py.
//
// Exposed C ABI (ctypes):
//   pack_ascii(ascii, n, codes, amb)        -> void
//   pack_2bit(codes, n, out)                -> void
//   fasta_scan(buf, len, codes, amb, starts, max_recs) -> n_records
//     codes/amb are filled with the concatenated per-record sequences;
//     starts[i] = offset of record i in codes; starts[n_records] = total.
//   kmer_values_u64(codes, pos, m, k, canonical, out) -> void

#include <cstddef>
#include <cstdint>
#include <cstring>

extern "C" {

static uint8_t IS_ACGT[256];
static bool init_done = false;

static void init_tables() {
    if (init_done) return;
    for (int i = 0; i < 256; i++) IS_ACGT[i] = 0;
    const char* s = "ACGTacgt";
    for (int i = 0; i < 8; i++) IS_ACGT[(uint8_t)s[i]] = 1;
    init_done = true;
}

// Branchless per-byte transform that gcc auto-vectorizes (the IS_ACGT
// table gather does not): amb via 4 byte-compares on the case-folded
// char instead of a lookup. Measured ~20x the byte-at-a-time loop on
// this host (70 MB/s -> GB/s-class).
static inline void transform_span(const uint8_t* p, size_t n,
                                  uint8_t* codes, uint8_t* amb) {
    for (size_t j = 0; j < n; j++) {
        uint8_t c = p[j];
        uint8_t lc = (uint8_t)(c | 0x20);
        codes[j] = (uint8_t)((c >> 1) & 3);
        amb[j] = (uint8_t)(1 - ((lc == 'a') | (lc == 'c') |
                                (lc == 'g') | (lc == 't')));
    }
}

// codes[i] = (ascii[i] >> 1) & 3; amb[i] = 1 iff not ACGT/acgt.
void pack_ascii(const uint8_t* ascii, size_t n, uint8_t* codes, uint8_t* amb) {
    transform_span(ascii, n, codes, amb);
}

// 2-bit pack: out[i/4] gets base i at bits 2*(i%4).
void pack_2bit(const uint8_t* codes, size_t n, uint8_t* out) {
    size_t nb = n / 4;
    for (size_t b = 0; b < nb; b++) {
        const uint8_t* c = codes + 4 * b;
        out[b] = (uint8_t)(c[0] | (c[1] << 2) | (c[2] << 4) | (c[3] << 6));
    }
    if (n % 4) {
        uint8_t v = 0;
        for (size_t i = 4 * nb; i < n; i++) v |= (uint8_t)(codes[i] << (2 * (i % 4)));
        out[nb] = v;
    }
}

// Line-oriented FASTA scan: concatenates record sequences into
// codes/amb, recording record start offsets. Handles \r\n, multi-line
// records, lowercase, and arbitrary IUPAC letters (flagged ambiguous).
// Lines are delimited with memchr (SIMD in libc) and each line body runs
// through the vectorized transform, so throughput is memory-bound rather
// than branch-bound (the old byte-at-a-time loop measured ~70 MB/s on
// this host; this form is ~GB/s). A '\r' is only recognized at end of
// line (the \r\n convention), matching the NumPy fallback's rstrip.
int64_t fasta_scan(const uint8_t* buf, size_t len, uint8_t* codes,
                   uint8_t* amb, int64_t* starts, int64_t max_recs) {
    int64_t nrec = 0;
    size_t w = 0;
    size_t i = 0;
    while (i < len) {
        const uint8_t* nl =
            (const uint8_t*)memchr(buf + i, '\n', len - i);
        size_t e = nl ? (size_t)(nl - buf) : len;
        if (buf[i] == '>') {  // header line
            if (nrec >= max_recs) return -1;
            starts[nrec++] = (int64_t)w;
        } else {
            size_t n = e - i;
            if (n && buf[e - 1] == '\r') n--;
            if (n && nrec == 0) {
                // data before any '>' opens an implicit record 0
                // (headerless FASTA), matching the NumPy fallback
                if (max_recs < 1) return -1;
                starts[nrec++] = 0;
            }
            transform_span(buf + i, n, codes + w, amb + w);
            w += n;
        }
        i = e + 1;
    }
    starts[nrec] = (int64_t)w;
    return nrec;
}

// Host-side k-mer value extraction (the reference's Output::values_u64,
// /root/reference/src/lib.rs:598-612): value = 2-bit codes packed with
// char i at bits 2*i; canonical = min(fwd, revcomp), complement = c ^ 2.
// One pass per position (~2 cache lines of codes each) instead of the
// NumPy (m, k) index-matrix gather.
void kmer_values_u64(const uint8_t* codes, const uint32_t* pos, int64_t m,
                     int64_t k, int canonical, uint64_t* out) {
  for (int64_t i = 0; i < m; i++) {
    const uint8_t* p = codes + pos[i];
    uint64_t v = 0;
    for (int64_t j = 0; j < k; j++) v |= (uint64_t)p[j] << (2 * j);
    if (canonical) {
      uint64_t r = 0;
      for (int64_t j = 0; j < k; j++)
        r |= (uint64_t)(p[k - 1 - j] ^ 2) << (2 * j);
      if (r < v) v = r;
    }
    out[i] = v;
  }
}

}  // extern "C"
