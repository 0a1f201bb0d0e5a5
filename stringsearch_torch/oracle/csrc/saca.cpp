// Host-side trusted oracle for stringsearch_tpu.
//
// Capability parity with the reference's C engine (ref:
// crates/cdivsufsort/c-sources/{divsufsort.c,utils.c}): exact suffix-array
// construction, an O(n) suffix-array checker, exact pattern search over the
// SA, and BWT / inverse-BWT. The construction algorithm is deliberately a
// *different, independently implemented* SACA — SA-IS (Nong/Zhang/Chan
// 2009, induced sorting with LMS substrings) written from scratch — so the
// oracle is an independent second implementation for differential testing,
// the role cdivsufsort plays for divsufsort in the reference
// (ref: crates/divsuftest/src/main.rs:82-113 `crosscheck`).
//
// The suffix array of a string is unique, so outputs are byte-exact
// comparable across engines regardless of algorithm.
//
// Build: g++ -O2 -shared -fPIC -o libsaca.so saca.cpp

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

using i32 = int32_t;

inline void count_chars(const i32* T, i32 n, i32 K, i32* C) {
  std::memset(C, 0, sizeof(i32) * (size_t)K);
  for (i32 i = 0; i < n; ++i) C[T[i]]++;
}

inline void bucket_bounds(const i32* C, i32 K, bool tails, i32* B) {
  i32 sum = 0;
  for (i32 c = 0; c < K; ++c) {
    sum += C[c];
    B[c] = tails ? sum : sum - C[c];
  }
}

// One induced-sorting sweep pair: L-pass (left-to-right from bucket heads)
// then S-pass (right-to-left from bucket tails). Entries < 0 in SA are
// treated as empty.
void induce(const i32* T, i32* SA, const std::vector<bool>& is_s, i32 n,
            i32 K, std::vector<i32>& C, std::vector<i32>& B) {
  count_chars(T, n, K, C.data());
  bucket_bounds(C.data(), K, false, B.data());
  for (i32 i = 0; i < n; ++i) {
    i32 p = SA[i];
    if (p > 0 && !is_s[(size_t)p - 1]) SA[B[T[p - 1]]++] = p - 1;
  }
  bucket_bounds(C.data(), K, true, B.data());
  for (i32 i = n - 1; i >= 0; --i) {
    i32 p = SA[i];
    if (p > 0 && is_s[(size_t)p - 1]) SA[--B[T[p - 1]]] = p - 1;
  }
}

// Core SA-IS over an integer alphabet [0, K). Requires T[n-1] to be the
// unique smallest character (sentinel); the byte-level wrapper appends one.
void sais_core(const i32* T, i32* SA, i32 n, i32 K) {
  if (n == 1) {
    SA[0] = 0;
    return;
  }
  std::vector<bool> is_s((size_t)n);
  is_s[(size_t)n - 1] = true;
  for (i32 i = n - 2; i >= 0; --i)
    is_s[(size_t)i] =
        (T[i] < T[i + 1]) || (T[i] == T[i + 1] && is_s[(size_t)i + 1]);

  auto is_lms = [&](i32 i) {
    return i > 0 && is_s[(size_t)i] && !is_s[(size_t)i - 1];
  };

  std::vector<i32> C((size_t)K), B((size_t)K);

  // Stage 1: seed LMS suffixes at bucket tails (text order), induce once —
  // this sorts the LMS *substrings*.
  std::fill(SA, SA + n, -1);
  count_chars(T, n, K, C.data());
  bucket_bounds(C.data(), K, true, B.data());
  for (i32 i = n - 1; i >= 1; --i)
    if (is_lms(i)) SA[--B[T[i]]] = i;
  induce(T, SA, is_s, n, K, C, B);

  // Compact the sorted LMS positions into the front of SA.
  i32 n1 = 0;
  for (i32 i = 0; i < n; ++i)
    if (is_lms(SA[i])) SA[n1++] = SA[i];

  // Name LMS substrings into the back half of SA (indexed by pos/2: LMS
  // positions are never adjacent, so pos/2 slots are collision-free).
  std::fill(SA + n1, SA + n, -1);
  i32 name = 0, prev = -1;
  for (i32 r = 0; r < n1; ++r) {
    i32 pos = SA[r];
    bool same = false;
    if (prev >= 0) {
      // Compare the two LMS substrings char by char until both hit their
      // terminating LMS position. Chars alone suffice: within an LMS
      // substring the type sequence is determined by the chars.
      same = true;
      for (i32 d = 0;; ++d) {
        bool alms = d > 0 && is_lms(pos + d);
        bool blms = d > 0 && is_lms(prev + d);
        if (alms && blms) break;
        if (alms != blms || T[pos + d] != T[prev + d]) {
          same = false;
          break;
        }
      }
    }
    if (!same) {
      ++name;
      prev = pos;
    }
    SA[n1 + pos / 2] = name - 1;
  }

  // Gather the reduced string: names read out in LMS text order.
  std::vector<i32> lms_pos((size_t)n1);
  {
    i32 j = 0;
    for (i32 i = 1; i < n; ++i)
      if (is_lms(i)) lms_pos[(size_t)j++] = i;
  }
  std::vector<i32> T1v((size_t)n1);
  for (i32 j = 0; j < n1; ++j) T1v[(size_t)j] = SA[n1 + lms_pos[(size_t)j] / 2];

  std::vector<i32> SA1((size_t)n1);
  if (name < n1) {
    sais_core(T1v.data(), SA1.data(), n1, name);
  } else {
    for (i32 j = 0; j < n1; ++j) SA1[(size_t)T1v[(size_t)j]] = j;
  }

  // Stage 3: seed LMS suffixes at bucket tails in their now-known order,
  // induce once more to finish the full SA.
  std::fill(SA, SA + n, -1);
  count_chars(T, n, K, C.data());
  bucket_bounds(C.data(), K, true, B.data());
  for (i32 r = n1 - 1; r >= 0; --r) {
    i32 j = lms_pos[(size_t)SA1[(size_t)r]];
    SA[--B[T[j]]] = j;
  }
  induce(T, SA, is_s, n, K, C, B);
}

}  // namespace

extern "C" {

// Build the suffix array of T[0..n) into SA[0..n). Returns 0, or -1 on bad
// arguments. (ref API: c-sources/divsufsort.h `divsufsort`)
i32 saca_build(const uint8_t* T, i32* SA, i32 n) {
  if (n < 0 || (n > 0 && (T == nullptr || SA == nullptr))) return -1;
  if (n == 0) return 0;
  if (n == 1) {
    SA[0] = 0;
    return 0;
  }
  // Shift bytes to [1, 256] and append sentinel 0 so SA-IS sees a unique
  // smallest last character; drop the sentinel row on output.
  std::vector<i32> Tp((size_t)n + 1);
  for (i32 i = 0; i < n; ++i) Tp[(size_t)i] = (i32)T[i] + 1;
  Tp[(size_t)n] = 0;
  std::vector<i32> SAp((size_t)n + 1);
  sais_core(Tp.data(), SAp.data(), n + 1, 257);
  // SAp[0] is the sentinel suffix (== n).
  std::memcpy(SA, SAp.data() + 1, sizeof(i32) * (size_t)n);
  return 0;
}

// O(n) suffix-array checker, 3 stages like the reference's sufcheck
// (ref: c-sources/utils.c:160-241): (1) range+permutation, (2) first
// characters nondecreasing, (3) ISA-recurrence on equal first chars.
// Returns 0 if valid, -k for stage-k failure.
i32 saca_sufcheck(const uint8_t* T, const i32* SA, i32 n) {
  if (n < 0) return -1;
  if (n == 0) return 0;
  std::vector<i32> isa((size_t)n, -1);
  for (i32 i = 0; i < n; ++i) {
    if (SA[i] < 0 || SA[i] >= n) return -1;
    if (isa[(size_t)SA[i]] != -1) return -1;  // duplicate
    isa[(size_t)SA[i]] = i;
  }
  for (i32 i = 1; i < n; ++i)
    if (T[SA[i - 1]] > T[SA[i]]) return -2;
  auto rank_next = [&](i32 p) { return p + 1 < n ? isa[(size_t)p + 1] : -1; };
  for (i32 i = 1; i < n; ++i)
    if (T[SA[i - 1]] == T[SA[i]] &&
        !(rank_next(SA[i - 1]) < rank_next(SA[i])))
      return -3;
  return 0;
}

// Exact occurrence search: returns the number of occurrences of P in T and
// stores the leftmost matching SA index in *idx (the lower bound when the
// count is 0). (ref API: c-sources/utils.c:244-325 `sa_search`)
int64_t saca_search(const uint8_t* T, i32 Tn, const uint8_t* P, i32 Pn,
                    const i32* SA, i32 SAn, i32* idx) {
  if (Tn < 0 || Pn < 0 || SAn != Tn) return -1;
  if (Pn == 0) {
    if (idx) *idx = 0;
    return Tn;
  }
  auto cmp = [&](i32 pos) {  // m-prefix of suffix vs P: -1/0/+1
    i32 len = Tn - pos < Pn ? Tn - pos : Pn;
    int c = std::memcmp(T + pos, P, (size_t)len);
    if (c != 0) return c < 0 ? -1 : 1;
    return len < Pn ? -1 : 0;  // suffix ran out → less
  };
  i32 lo = 0, hi = Tn;
  while (lo < hi) {  // lower bound: first suffix with prefix >= P
    i32 mid = lo + (hi - lo) / 2;
    if (cmp(SA[mid]) < 0) lo = mid + 1;
    else hi = mid;
  }
  i32 lb = lo;
  hi = Tn;
  while (lo < hi) {  // upper bound: first suffix with prefix > P
    i32 mid = lo + (hi - lo) / 2;
    if (cmp(SA[mid]) <= 0) lo = mid + 1;
    else hi = mid;
  }
  if (idx) *idx = lb;
  return (int64_t)(lo - lb);
}

// Single-character occurrence search (ref API: c-sources/utils.c:328-381
// `sa_simplesearch`): count + leftmost SA index of suffixes starting with c.
int64_t saca_simplesearch(const uint8_t* T, i32 Tn, const i32* SA, i32 SAn,
                          i32 c, i32* idx) {
  if (Tn < 0 || SAn != Tn || c < 0 || c > 255) return -1;
  i32 lo = 0, hi = Tn;
  while (lo < hi) {  // lower bound
    i32 mid = lo + (hi - lo) / 2;
    if ((i32)T[SA[mid]] < c) lo = mid + 1;
    else hi = mid;
  }
  i32 lb = lo;
  hi = Tn;
  while (lo < hi) {  // upper bound
    i32 mid = lo + (hi - lo) / 2;
    if ((i32)T[SA[mid]] <= c) lo = mid + 1;
    else hi = mid;
  }
  if (idx) *idx = lb;
  return (int64_t)(lo - lb);
}

// Burrows–Wheeler transform via the suffix array.
// Convention (documented; round-trips with saca_unbwt):
//   U[0] = T[n-1]; the remaining n-1 bytes are T[SA[i]-1] for SA rows i in
//   order, skipping the row with SA[i] == 0; returns pidx = that row's
//   index. (ref capability: c-sources/divsufsort.c `divbwt` +
//   utils.c:52-108 `bw_transform`)
i32 saca_bwt(const uint8_t* T, uint8_t* U, i32 n) {
  if (n < 0) return -1;
  if (n == 0) return 0;
  std::vector<i32> SA((size_t)n);
  if (saca_build(T, SA.data(), n) != 0) return -1;
  i32 pidx = -1;
  U[0] = T[n - 1];
  i32 k = 1;
  for (i32 i = 0; i < n; ++i) {
    if (SA[(size_t)i] == 0) {
      pidx = i;
      continue;
    }
    U[k++] = T[SA[(size_t)i] - 1];
  }
  return pidx;
}

// Inverse BWT matching saca_bwt's convention. Reconstructs T from (U, pidx).
// (ref capability: c-sources/utils.c:111-157 `inverse_bw_transform`)
i32 saca_unbwt(const uint8_t* U, uint8_t* T, i32 n, i32 pidx) {
  if (n < 0 || pidx < 0 || pidx >= (n > 0 ? n : 1)) return -1;
  if (n == 0) return 0;
  // Rebuild the sentinel-augmented BWT column B of length n+1: row r of the
  // sorted sentinel-suffix matrix. Row 0 is the sentinel suffix (char
  // T[n-1] = U[0]); the full-string row sits at r = pidx + 1 and its column
  // char is the virtual sentinel.
  // LF-walk: stable-rank each char; sentinel is smallest.
  std::vector<i32> B((size_t)n + 1);
  B[0] = (i32)U[0] + 1;
  for (i32 r = 1, k = 1; r <= n; ++r) {
    if (r == pidx + 1) {
      B[(size_t)r] = 0;  // virtual sentinel char
    } else {
      B[(size_t)r] = (i32)U[k++] + 1;
    }
  }
  // counts and cumulative starts over alphabet [0, 257)
  i32 C[258];
  std::memset(C, 0, sizeof(C));
  for (i32 r = 0; r <= n; ++r) C[B[(size_t)r] + 1]++;
  for (i32 c = 1; c < 258; ++c) C[c] += C[c - 1];
  // LF mapping with stable ranks
  std::vector<i32> LF((size_t)n + 1);
  {
    i32 occ[257];
    std::memset(occ, 0, sizeof(occ));
    for (i32 r = 0; r <= n; ++r) {
      i32 c = B[(size_t)r];
      LF[(size_t)r] = C[c] + occ[c];
      occ[c]++;
    }
  }
  // Walk the LF mapping starting from row 0 (the sentinel suffix "$"):
  // row r holds the suffix starting at position s, B[r] is T[s-1], and
  // LF(r) is the row of the suffix starting at s-1 — so the walk emits T
  // right to left and terminates at the full-string row (pidx + 1).
  i32 row = 0;
  for (i32 k = n - 1; k >= 0; --k) {
    i32 c = B[(size_t)row];
    // c == 0 would mean we hit the sentinel early — corrupt input.
    if (c == 0) return -2;
    T[k] = (uint8_t)(c - 1);
    row = LF[(size_t)row];
  }
  return 0;
}

const char* saca_version() { return "stringsearch_tpu-oracle-0.1 (SA-IS)"; }

}  // extern "C"
