// hal_tpu_torch's copy of the native column engine (native/column_engine.cpp,
// which the JAX package builds and tests): the exact hal2maf hot path in
// C++17, built for the port by hal_tpu_torch/ops/_native_build.py.
//
// It implements the same two algorithms the Python packages define and
// test:
//
//   * the run-hoisted column DFS of ops/column.py (ColumnDFS /
//     iter_slices_exact): one tree spreading per RUN of identical columns
//     instead of the reference's per-column recursion
//     (HAL api/impl/halColumnIterator.cpp:65-145, 246-356, 557-745 —
//     behaviourally equivalent, structurally re-designed),
//   * the MAF block entry state machine of io/maf_io.py (MafBlockBuilder),
//     reproducing HAL's MafBlock rules (maf/impl/halMafBlock.cpp:
//     initBlock :294, appendColumn :370, canAppendColumn :401, printBlock
//     :499, resetEntries :36-79) byte-for-byte.
//
// It reads the columnar genome arrays (int64 starts/links, uint8 flags,
// nibble-packed DNA) in place — zero copies — and emits finished MAF text
// into a buffer the Python binding drains per window.  Python remains the
// oracle: tests assert byte equality against the pure-Python path on every
// flag combination, and against the original library.
//
// The one divergence from the original is the block machine's text sink:
// every call plans its blocks without writing text, then writes every
// closed block once at its final offset in an exact-size buffer
// (begin_plan, end_plan, write_planned).  The fragment assembler that the
// device column engine feeds splits the two (ce_plan_frags /
// ce_write_frags); the host DFS paths (ce_export) and ce_finish plan and
// write in one call.  The bytes are the original's.
//
// --maxRefGap indel stacks (ColumnDFS eval_del_site/eval_ins_site + the
// iter_slices_exact stack walker) and the --global shared visit cache
// (PosCache, persisted across ce_set_ref passes) are native too.
// Not handled here (Python fallback): --printTree gene trees.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <set>
#include <string>
#include <vector>

namespace {

constexpr int64_t NULL_INDEX = -1;

// 4-bit nibble code -> ASCII base (dna.py UNPACK_MAP; layout per HAL
// api/inc/halCommon.h:183-196: even position = high nibble)
const char UNPACK[16] = {'a', 'c', 'g', 't', 'n', 0, 0, 0,
                         'A', 'C', 'G', 'T', 'N', 0, 0, 0};

struct CompTable {
  char m[256];
  CompTable() {
    for (int i = 0; i < 256; ++i) m[i] = static_cast<char>(i);
    const char* a = "acgtACGT";
    const char* b = "tgcaTGCA";
    for (int i = 0; i < 8; ++i) m[static_cast<unsigned char>(a[i])] = b[i];
  }
};
const CompTable COMP;

// packed byte -> its two bases in position order (high nibble, then low),
// and in reverse-complement order (the low nibble's complement, then the
// high one's): the write pass decodes two positions a byte
struct PairTable {
  char fwd[256][2], rev[256][2];
  PairTable() {
    for (int b = 0; b < 256; ++b) {
      char hi = UNPACK[b >> 4], lo = UNPACK[b & 0xF];
      fwd[b][0] = hi;
      fwd[b][1] = lo;
      rev[b][0] = COMP.m[static_cast<unsigned char>(lo)];
      rev[b][1] = COMP.m[static_cast<unsigned char>(hi)];
    }
  }
};
const PairTable PAIRS;

// the k bases from position lo upwards
inline void put_fwd(char* dst, const uint8_t* dna, int64_t lo, int64_t k) {
  if (k > 0 && (lo & 1)) {
    *dst++ = UNPACK[dna[lo >> 1] & 0xF];
    ++lo;
    --k;
  }
  int64_t b = lo >> 1;
  for (int64_t n = k >> 1; n > 0; --n, ++b, dst += 2)
    std::memcpy(dst, PAIRS.fwd[dna[b]], 2);
  if (k & 1) *dst = UNPACK[dna[b] >> 4];
}

// the k complemented bases from position hi - 1 downwards
inline void put_rev(char* dst, const uint8_t* dna, int64_t hi, int64_t k) {
  int64_t p = hi - 1;
  if (k > 0 && !(p & 1)) {
    *dst++ = COMP.m[static_cast<unsigned char>(UNPACK[dna[p >> 1] >> 4])];
    --p;
    --k;
  }
  int64_t b = p >> 1;  // p is odd: positions p, p - 1 are byte b's low, high
  for (int64_t n = k >> 1; n > 0; --n, --b, dst += 2)
    std::memcpy(dst, PAIRS.rev[dna[b]], 2);
  if (k & 1) *dst = COMP.m[static_cast<unsigned char>(UNPACK[dna[b] & 0xF])];
}

// the first i in [lo, n) with c[i] >= v, for a sorted c, searched outward
// from lo: a few steps where v lies near c[lo]
inline int64_t gallop(const int64_t* c, int64_t n, int64_t lo, int64_t v) {
  int64_t hi = lo;
  for (int64_t step = 1; hi < n && c[hi] < v; step <<= 1) {
    lo = hi + 1;
    hi += step;
  }
  if (hi > n) hi = n;
  return std::lower_bound(c + lo, c + hi, v) - c;
}

inline int64_t int_len(int64_t v) {  // characters put_int writes
  int64_t n = v < 0 ? 2 : 1;
  uint64_t u = v < 0 ? static_cast<uint64_t>(-v) : static_cast<uint64_t>(v);
  while (u >= 10) {
    u /= 10;
    ++n;
  }
  return n;
}

inline char* put_int(char* p, int64_t v) {  // v in decimal at p
  int64_t n = int_len(v);
  char* q = p + n;
  bool neg = v < 0;
  uint64_t u = neg ? static_cast<uint64_t>(-v) : static_cast<uint64_t>(v);
  do {
    *--q = static_cast<char>('0' + (u % 10));
    u /= 10;
  } while (u);
  if (neg) *--q = '-';
  return p + n;
}

struct GenomeT {
  std::string name;
  const int64_t* seq_start = nullptr;  // n_seq+1
  const int64_t* seq_top = nullptr;    // n_seq+1
  const int64_t* seq_bot = nullptr;    // n_seq+1
  const int64_t* top_start = nullptr;  // n_top+1
  const int64_t* top_parent = nullptr;
  const uint8_t* top_rev = nullptr;
  const int64_t* top_para = nullptr;    // may be null
  const int64_t* top_bparse = nullptr;  // may be null
  const int64_t* bot_start = nullptr;   // n_bot+1
  const int64_t* bot_tparse = nullptr;  // may be null
  const int64_t* bot_child = nullptr;   // (n_bot, n_children) row-major
  const uint8_t* bot_crev = nullptr;
  const uint8_t* dna = nullptr;  // nibble-packed, may be null
  int64_t n_seq = 0, n_top = 0, n_bot = 0, n_children = 0;
  int64_t parent = -1;          // genome id
  int64_t slot_in_parent = -1;  // my column in parent's bot_child
  std::vector<int64_t> children;
  std::vector<std::string> seq_names;  // display names (ucsc applied)
  int64_t name_rank = 0;
  bool in_scope = true, is_target = true, is_leaf = true;

  inline int64_t seq_of(int64_t pos) const {
    if (n_seq <= 1) return 0;
    return std::upper_bound(seq_start, seq_start + n_seq + 1, pos) -
           seq_start - 1;
  }
  inline int64_t top_at(int64_t pos) const {
    return std::upper_bound(top_start, top_start + n_top + 1, pos) -
           top_start - 1;
  }
  inline int64_t bot_at(int64_t pos) const {
    return std::upper_bound(bot_start, bot_start + n_bot + 1, pos) -
           bot_start - 1;
  }
};

struct RowRef {  // one DFS-inserted position
  int32_t gid;
  uint8_t rev;
  int64_t pos;
};

struct BRow {  // a run row fed to the block machine
  int32_t gid;
  int32_t seq;
  uint8_t rev;
  int64_t lo, hi;  // remaining target range of the (possibly split) run
};

// --------------------------------------------------------------------------
// MAF block entry machine (mirror of io/maf_io.py MafBlockBuilder,
// reference halMafBlock.cpp).
// --------------------------------------------------------------------------

struct Entry {
  int64_t key_rank;  // genome name rank (SequenceLess major key)
  int64_t key_seq;   // sequence array index (minor key)
  const std::string* name;
  int32_t gid;
  int64_t src_length;
  int64_t seq_start0;  // genome coordinate of the sequence start
  int64_t start = -1;  // strand coords; -1 == NULL
  int64_t length = 0;
  bool neg = false;
  int last_used = 0;
  std::string text;  // the open block's columns staged by the last call
};

// PositionCache: sorted disjoint half-open [lo, hi) interval set
// (mirror of ops/poscache.py; reference halPositionCache.cpp)
struct PosCache {
  std::map<int64_t, int64_t> iv;  // lo -> hi

  void add(int64_t lo, int64_t hi) {
    if (hi <= lo) return;
    auto it = iv.upper_bound(lo);
    if (it != iv.begin()) {
      auto prev = std::prev(it);
      if (prev->second >= lo) {
        lo = prev->first;
        it = prev;
      }
    }
    while (it != iv.end() && it->first <= hi) {
      hi = std::max(hi, it->second);
      it = iv.erase(it);
    }
    iv[lo] = hi;
  }

  bool covers(int64_t lo, int64_t hi) const {
    auto it = iv.upper_bound(lo);
    if (it == iv.begin()) return false;
    return std::prev(it)->second >= hi;
  }

  // interval containing p, or false
  bool interval_at(int64_t p, int64_t* lo, int64_t* hi) const {
    auto it = iv.upper_bound(p);
    if (it == iv.begin()) return false;
    auto prev = std::prev(it);
    if (prev->second > p) {
      *lo = prev->first;
      *hi = prev->second;
      return true;
    }
    return false;
  }

  int64_t free_run(int64_t p, bool forward) const {
    auto it = iv.upper_bound(p);
    if (it != iv.begin() && std::prev(it)->second > p) return 0;
    if (forward) {
      if (it != iv.end()) return it->first - p;
    } else {
      if (it != iv.begin()) return p - std::prev(it)->second + 1;
    }
    return int64_t(1) << 62;
  }

  // pieces of cached intervals clamped to [lo, hi)
  template <class F>
  void overlaps(int64_t lo, int64_t hi, F&& fn) const {
    auto it = iv.upper_bound(lo);
    if (it != iv.begin()) --it;
    for (; it != iv.end() && it->first < hi; ++it) {
      int64_t a = std::max(it->first, lo);
      int64_t b = std::min(it->second, hi);
      if (a < b) fn(a, b);
    }
  }
};

// The planned sink's records: a run of k columns and
// its rows, each naming the entry slot it feeds and its DNA; a printed
// line; a closed block with its exact size and offset in the text.
struct PRow {
  int32_t slot, gid;
  uint8_t rev;
  int64_t pos;  // the row's lo (forward) or hi (reverse)
};
struct PRun {
  int64_t k;
  size_t row0, row1;
};
struct PLine {
  const std::string* name;
  int64_t start, length, src_length;
  int32_t slot;
  int32_t prefix;  // index into Engine::carried, or -1
  bool neg;
};
struct PBlock {
  size_t line0, line1, run0, run1;
  int64_t width, prefix_w, off, bytes;
};

struct Engine {
  std::vector<GenomeT> g;
  int32_t ref = 0;
  bool no_dupes = false, no_ancestors = false, only_orthologs = false;
  bool unique = false, has_scope = false, has_targets = false;
  bool keep_empty_ref_blocks = true;
  int64_t max_len = 1000;

  // --maxRefGap indel stacks + --global shared visit cache (ports of
  // ops/column.py ColumnDFS indel machinery + iter_slices_exact's
  // stack walker / shared_visit branch — the Python implementations are
  // the tested spec; reference halColumnIterator.cpp:357-440 indel
  // recursion + halMafExport.cpp:90-160 global mode)
  int64_t max_ref_gap = 0;
  bool global_mode = false;
  struct Site {
    int32_t gid;
    int64_t i, rem;
    bool o;
  };
  std::vector<Site> del_sites, ins_sites;
  bool track_visits = false;
  std::vector<RowRef> visits;
  std::map<int32_t, PosCache> visit;         // per-window indel cache
  std::map<int32_t, PosCache> shared_visit;  // --global, across refs

  // DFS state
  std::vector<RowRef> rows;
  std::vector<std::pair<int64_t, uint8_t>> refpos;
  int64_t limit = 0;

  // block machine state
  std::vector<std::unique_ptr<Entry>> entries;
  Entry* reference = nullptr;
  int64_t ref_index = -1;  // -1 == None
  bool started = false;

  std::string out;  // finished MAF text, drained by the binding
  std::vector<BRow> brows;

  // ---------------------------------------------- the planned text sink
  // The block machine records instead of appending text: each append_run
  // is a PRun of k columns, whose PRows name the entry slot and the DNA
  // that feeds it ('-' where no row does), and each printed block a PBlock
  // of PLines with the block's exact size and offset.  write_planned then
  // writes every block at its offset.
  bool plan_error = false;
  std::vector<PRow> prows;
  std::vector<PRun> pruns;
  std::vector<PLine> plines;
  std::vector<PBlock> pblocks;
  // staged text of the block a previous call left open (its width is
  // open_prefix_w), copied here when that block closes in this plan
  std::vector<std::string> carried;
  size_t open_run0 = 0, open_row0 = 0;  // the open block's first run, row
  int64_t open_cols = 0;                // columns this plan fed it
  int64_t open_prefix_w = 0;
  int64_t planned_bytes = 0, direct_cols = 0, staged_cols = 0;
  std::vector<std::pair<int32_t, char*>> line_dst;  // (slot, text) a block

  // ---------------------------------------------------------- DFS helpers
  inline void limit_seg(const int64_t* starts, int64_t i, int64_t pos,
                        bool rev) {
    int64_t rem = rev ? pos - starts[i] + 1 : starts[i + 1] - pos;
    if (rem < limit) limit = rem;
  }

  inline void insert(int32_t gid, int64_t pos, bool rev) {
    if (unique && gid == ref) refpos.emplace_back(pos, rev ? 1 : 0);
    if (track_visits)
      visits.push_back({gid, static_cast<uint8_t>(rev ? 1 : 0), pos});
    const GenomeT& t = g[gid];
    if (no_ancestors && !t.is_leaf) return;
    if (has_targets && !t.is_target) return;
    rows.push_back({gid, static_cast<uint8_t>(rev ? 1 : 0), pos});
  }

  inline bool parent_in_scope(int32_t gid) const {
    if (!has_scope) return true;
    int64_t p = g[gid].parent;
    return p >= 0 && g[p].in_scope;
  }

  inline bool is_canonical(const GenomeT& t, int64_t i) const {
    int64_t pi = t.top_parent[i];
    if (pi < 0) return false;
    const GenomeT& pt = g[t.parent];
    return pt.bot_child[pi * pt.n_children + t.slot_in_parent] == i;
  }

  // mirror of ColumnDFS._update_parent (column.py:411-430)
  void update_parent(int32_t gid, const GenomeT& t, int64_t i, int64_t pos,
                     bool rev) {
    int64_t pi = t.top_parent[i];
    if (pi < 0 || !parent_in_scope(gid)) return;
    if (no_dupes && !is_canonical(t, i)) return;
    int32_t parent = static_cast<int32_t>(t.parent);
    const GenomeT& pt = g[parent];
    bool prev = t.top_rev[i] != 0;
    int64_t off = pos - t.top_start[i];
    int64_t seg_len = t.top_start[i + 1] - t.top_start[i];
    int64_t ppos = pt.bot_start[pi] + (prev ? seg_len - 1 - off : off);
    bool nrev = rev ^ prev;
    limit_seg(pt.bot_start, pi, ppos, nrev);
    insert(parent, ppos, nrev);
    parse_up(parent, pt, pi, ppos, nrev);
    int64_t my_slot = t.slot_in_parent;
    for (int64_t slot = 0; slot < pt.n_children; ++slot) {
      if (slot != my_slot)
        update_child(parent, pt, pi, ppos, nrev, slot,
                     static_cast<int32_t>(pt.children[slot]));
    }
  }

  // mirror of ColumnDFS._update_child (column.py:432-447)
  void update_child(int32_t gid, const GenomeT& t, int64_t b, int64_t pos,
                    bool rev, int64_t slot, int32_t child) {
    int64_t j = t.bot_child[b * t.n_children + slot];
    if (j < 0 || (has_scope && !g[child].in_scope)) return;
    const GenomeT& ct = g[child];
    bool crev = t.bot_crev[b * t.n_children + slot] != 0;
    int64_t off = pos - t.bot_start[b];
    int64_t seg_len = t.bot_start[b + 1] - t.bot_start[b];
    int64_t cpos = ct.top_start[j] + (crev ? seg_len - 1 - off : off);
    bool nrev = rev ^ crev;
    limit_seg(ct.top_start, j, cpos, nrev);
    insert(child, cpos, nrev);
    if (max_ref_gap > 0) site(ins_sites, child, ct, j, cpos, nrev);
    next_top_dup(child, ct, j, cpos, nrev);
    parse_down(child, ct, j, cpos, nrev);
  }

  // ColumnDFS._site (column.py:370-377): record an indel discovery site;
  // it fires only when the run ends exactly at the segment's traversal end
  inline void site(std::vector<Site>& sites, int32_t gid, const GenomeT& t,
                   int64_t i, int64_t pos, bool o) {
    int64_t rem = o ? pos - t.top_start[i] + 1 : t.top_start[i + 1] - pos;
    sites.push_back({gid, i, rem, o});
  }

  // mirror of ColumnDFS._next_top_dup (column.py:449-473)
  void next_top_dup(int32_t gid, const GenomeT& t, int64_t i, int64_t pos,
                    bool rev) {
    if (no_dupes || t.top_para == nullptr || t.top_para[i] < 0 ||
        t.parent < 0 || !parent_in_scope(gid))
      return;
    int64_t first = i;
    int64_t cur = i, cpos = pos;
    bool crev = rev;
    while (true) {
      int64_t m = t.top_para[cur];
      bool flip = (t.top_rev[cur] != 0) != (t.top_rev[m] != 0);
      int64_t off = cpos - t.top_start[cur];
      int64_t seg_len = t.top_start[cur + 1] - t.top_start[cur];
      int64_t mpos = t.top_start[m] + (flip ? seg_len - 1 - off : off);
      bool mrev = crev ^ flip;
      limit_seg(t.top_start, m, mpos, mrev);
      insert(gid, mpos, mrev);
      if (max_ref_gap > 0) site(ins_sites, gid, t, m, mpos, mrev);
      parse_down(gid, t, m, mpos, mrev);
      cur = m;
      cpos = mpos;
      crev = mrev;
      int64_t nxt = t.top_para[cur];
      if (nxt < 0 || nxt == first) break;
    }
  }

  // mirror of ColumnDFS._parse_up (column.py:475-489, sans indel sites)
  void parse_up(int32_t gid, const GenomeT& t, int64_t b, int64_t pos,
                bool rev) {
    if (t.bot_tparse == nullptr || t.bot_tparse[b] < 0) return;
    int64_t i = t.top_at(pos);
    limit_seg(t.top_start, i, pos, rev);
    update_parent(gid, t, i, pos, rev);
    if (!only_orthologs) next_top_dup(gid, t, i, pos, rev);
    if (max_ref_gap > 0) site(del_sites, gid, t, i, pos, rev);
  }

  // mirror of ColumnDFS._parse_down (column.py:491-499)
  void parse_down(int32_t gid, const GenomeT& t, int64_t i, int64_t pos,
                  bool rev) {
    if (t.top_bparse == nullptr || t.top_bparse[i] < 0) return;
    int64_t b = t.bot_at(pos);
    limit_seg(t.bot_start, b, pos, rev);
    for (int64_t slot = 0; slot < t.n_children; ++slot)
      update_child(gid, t, b, pos, rev, slot,
                   static_cast<int32_t>(t.children[slot]));
  }

  // mirror of ColumnDFS.run_from (column.py:324-368): DFS from any
  // (genome, pos, rev) — rev walks the entry right-to-left (a reversed
  // indel stack entry)
  void run_from(int32_t gid, int64_t pos, bool rev) {
    rows.clear();
    refpos.clear();
    if (max_ref_gap > 0) {
      del_sites.clear();
      ins_sites.clear();
    }
    if (track_visits) visits.clear();
    const GenomeT& t = g[gid];
    int64_t si = t.seq_of(pos);
    bool seq_has_tops = t.seq_top[si + 1] - t.seq_top[si] > 0;
    limit = rev ? pos - t.seq_start[si] + 1 : t.seq_start[si + 1] - pos;
    if (seq_has_tops) {
      int64_t i = t.top_at(pos);
      limit_seg(t.top_start, i, pos, rev);
      insert(gid, pos, rev);
      if (max_ref_gap > 0) site(del_sites, gid, t, i, pos, rev);
      update_parent(gid, t, i, pos, rev);
      if (!only_orthologs) next_top_dup(gid, t, i, pos, rev);
      parse_down(gid, t, i, pos, rev);
    } else {
      int64_t b = t.bot_at(pos);
      limit_seg(t.bot_start, b, pos, rev);
      insert(gid, pos, rev);
      for (int64_t slot = 0; slot < t.n_children; ++slot)
        update_child(gid, t, b, pos, rev, slot,
                     static_cast<int32_t>(t.children[slot]));
    }
  }

  void run_dfs(int64_t pos) { run_from(ref, pos, false); }

  // -------------------------------------------------------- block machine

  static inline bool key_less(const Entry* e, int64_t rank, int64_t seq) {
    return e->key_rank != rank ? e->key_rank < rank : e->key_seq < seq;
  }

  void reset_entries() {  // resetEntries (halMafBlock.cpp:36-79)
    size_t w = 0;
    for (size_t i = 0; i < entries.size(); ++i) {
      Entry* e = entries[i].get();
      if (e->start == -1) {
        if (e->last_used > 10) continue;
        e->last_used += 1;
      } else {
        e->last_used = 0;
      }
      e->start = -1;
      e->neg = false;
      e->length = 0;
      e->text.clear();
      if (w != i) entries[w] = std::move(entries[i]);
      ++w;
    }
    entries.resize(w);
    reference = nullptr;
    ref_index = -1;
    // the block closed (flush recorded its runs if it printed): what it
    // did not record goes with its staged text
    direct_cols += open_cols;
    open_cols = 0;
    open_prefix_w = 0;
    pruns.resize(open_run0);
    prows.resize(open_row0);
  }

  inline int64_t row_start_strand(const BRow& r, int64_t* src_len) const {
    const GenomeT& t = g[r.gid];
    int64_t s0 = t.seq_start[r.seq];
    int64_t sl = t.seq_start[r.seq + 1] - s0;
    *src_len = sl;
    return r.rev ? sl - 1 - (r.hi - 1 - s0) : r.lo - s0;
  }

  void init_block(int64_t slice_lo) {  // initBlock (halMafBlock.cpp:294-368)
    reset_entries();
    // dupe counting: d-th row of a key -> d-th entry of that key
    for (size_t ri = 0; ri < brows.size(); ++ri) {
      const BRow& row = brows[ri];
      int64_t rank = g[row.gid].name_rank;
      // d = how many earlier rows share this key
      int64_t d = 0;
      for (size_t q = 0; q < ri; ++q)
        if (brows[q].gid == row.gid && brows[q].seq == row.seq) ++d;
      // base = bisect_left(keys, key)
      size_t base = std::lower_bound(entries.begin(), entries.end(), 0,
                                     [&](const std::unique_ptr<Entry>& e,
                                         int) {
                                       return key_less(e.get(), rank, row.seq);
                                     }) -
                    entries.begin();
      size_t idx = base + d;
      Entry* entry;
      if (idx >= entries.size() || entries[idx]->key_rank != rank ||
          entries[idx]->key_seq != row.seq) {
        auto ne = std::make_unique<Entry>();
        ne->key_rank = rank;
        ne->key_seq = row.seq;
        ne->gid = row.gid;
        ne->name = &g[row.gid].seq_names[row.seq];
        ne->seq_start0 = g[row.gid].seq_start[row.seq];
        ne->src_length = g[row.gid].seq_start[row.seq + 1] - ne->seq_start0;
        entry = ne.get();
        // insert at bisect_right(keys, key): after every equal key
        size_t ins = entries.size();
        for (size_t q = base; q < entries.size(); ++q) {
          const Entry* cand = entries[q].get();
          if (cand->key_rank > rank ||
              (cand->key_rank == rank && cand->key_seq > row.seq)) {
            ins = q;
            break;
          }
        }
        entries.insert(entries.begin() + ins, std::move(ne));
      } else {
        entry = entries[idx].get();
      }
      int64_t src_len;
      entry->start = row_start_strand(row, &src_len);
      entry->neg = row.rev != 0;
      entry->length = 0;
      entry->text.clear();
    }

    // reference selection (halMafBlock.cpp:353-363)
    reference = nullptr;
    ref_index = -1;
    if (!brows.empty()) {
      const GenomeT& rg = g[ref];
      int64_t rsi = rg.seq_of(slice_lo);
      int64_t rrank = rg.name_rank;
      for (auto& e : entries) {
        if (e->key_rank == rrank && e->key_seq == rsi) {
          reference = e.get();
          ref_index = slice_lo - rg.seq_start[rsi];
          break;
        }
      }
    }
    if (reference == nullptr && !entries.empty()) {
      reference = entries[0].get();
      ref_index = -1;
    }
  }

  bool can_append() const {  // canAppendColumn (halMafBlock.cpp:401-450)
    size_t e = 0;
    for (const BRow& row : brows) {
      int64_t rank = g[row.gid].name_rank;
      while (e < entries.size() && !(entries[e]->key_rank == rank &&
                                     entries[e]->key_seq == row.seq))
        ++e;
      if (e >= entries.size()) return false;
      const Entry* entry = entries[e].get();
      if (entry->start != -1) {
        if (entry->length >= max_len) return false;
        if (entry->length > 0 && entry->neg != (row.rev != 0)) return false;
        int64_t src_len;
        int64_t start = row_start_strand(row, &src_len);
        if (start - entry->start != entry->length) return false;
      }
      ++e;
    }
    return true;
  }

  int64_t append_budget() const {
    int64_t budget = max_len;
    size_t e = 0;
    for (const BRow& row : brows) {
      int64_t rank = g[row.gid].name_rank;
      while (e < entries.size() && !(entries[e]->key_rank == rank &&
                                     entries[e]->key_seq == row.seq))
        ++e;
      if (e < entries.size()) {
        int64_t b = max_len - entries[e]->length;
        if (b < budget) budget = b;
        ++e;
      }
    }
    return budget;
  }

  // appendColumn for k columns of the current run (halMafBlock.cpp:370-395);
  // advances each row's remaining range in place
  void append_run(int64_t k) {
    size_t e = 0;
    size_t row0 = prows.size();
    for (BRow& row : brows) {
      int64_t rank = g[row.gid].name_rank;
      while (e < entries.size() && !(entries[e]->key_rank == rank &&
                                     entries[e]->key_seq == row.seq))
        ++e;
      Entry* entry = entries[e].get();
      if (entry->start == -1) {
        // late joiner keeps accumulated '-' padding (initEntry
        // clearSequence=false, halMafBlock.cpp:109-113)
        int64_t src_len;
        entry->start = row_start_strand(row, &src_len);
        entry->neg = row.rev != 0;
      }
      entry->length += k;
      prows.push_back({static_cast<int32_t>(e), row.gid, row.rev,
                       row.rev ? row.hi : row.lo});
      if (row.rev)
        row.hi -= k;
      else
        row.lo += k;
      ++e;
    }
    pruns.push_back({k, row0, prows.size()});
    open_cols += k;
  }

  // printBlock (halMafBlock.cpp:499-519); plans block + trailing '\n'
  // (the tool writes `block + "\n"` per yielded block)
  bool flush() {
    if (reference == nullptr) return false;
    if (!keep_empty_ref_blocks && !has_bases(reference)) return false;
    plan_block();
    int32_t ref_slot = slot_of(reference);
    if (reference->start == -1) {
      if (ref_index >= 0) plan_line(reference, ref_index, ref_slot);
    } else {
      plan_line(reference, -1, ref_slot);
    }
    for (size_t i = 0; i < entries.size(); ++i) {
      const Entry* e = entries[i].get();
      if (e->start != -1 && e != reference)
        plan_line(e, -1, static_cast<int32_t>(i));
    }
    end_planned_block();
    return true;
  }

  // whether the entry's line holds a base, not '-' alone: in its staged
  // text or in a run of this plan
  bool has_bases(const Entry* e) const {
    if (e->text.find_first_not_of('-') != std::string::npos) return true;
    int32_t slot = slot_of(e);
    for (size_t j = open_row0; j < prows.size(); ++j)
      if (prows[j].slot == slot) return true;
    return false;
  }

  int32_t slot_of(const Entry* e) const {
    for (size_t i = 0; i < entries.size(); ++i)
      if (entries[i].get() == e) return static_cast<int32_t>(i);
    return -1;
  }

  // ------------------------------------------- plan and write (planned)
  void plan_block() {
    PBlock b;
    b.line0 = b.line1 = plines.size();
    b.run0 = open_run0;
    b.run1 = pruns.size();
    b.prefix_w = open_prefix_w;
    b.width = open_prefix_w + open_cols;
    b.off = planned_bytes;
    b.bytes = 3;  // "a\n", and the block's closing "\n"
    pblocks.push_back(b);
  }

  // a line's sizes: "s\t" name "\t" start "\t" length "\t" strand
  // "\t" srcLength "\t" text "\n"
  void plan_line(const Entry* e, int64_t start_override, int32_t slot) {
    PBlock& b = pblocks.back();
    PLine l;
    l.name = e->name;
    l.start = start_override >= 0 ? start_override : e->start;
    l.length = e->length;
    l.src_length = e->src_length;
    l.neg = e->neg;
    l.slot = slot;
    l.prefix = -1;
    if (b.prefix_w > 0) {
      if (static_cast<int64_t>(e->text.size()) != b.prefix_w)
        plan_error = true;
      l.prefix = static_cast<int32_t>(carried.size());
      carried.push_back(e->text);
    }
    plines.push_back(l);
    b.line1 = plines.size();
    b.bytes += 2 + static_cast<int64_t>(l.name->size()) + 1 +
               int_len(l.start) + 1 + int_len(l.length) + 3 +
               int_len(l.src_length) + 1 + b.width + 1;
  }

  void end_planned_block() {
    planned_bytes += pblocks.back().bytes;
    open_run0 = pruns.size();  // the block keeps its runs
    open_row0 = prows.size();
  }

  // writes runs [run0, run1) from column col of each (slot, text) in dst,
  // which is in slot order as each run's rows are: a row's bases where
  // the run has one for the slot, else '-'
  void fill_runs(size_t run0, size_t run1,
                 const std::vector<std::pair<int32_t, char*>>& dst,
                 int64_t col) {
    for (size_t r = run0; r < run1; ++r) {
      const PRun& run = pruns[r];
      size_t j = run.row0;
      for (const auto& d : dst) {
        while (j < run.row1 && prows[j].slot < d.first) ++j;
        char* p = d.second + col;
        if (j < run.row1 && prows[j].slot == d.first) {
          const PRow& w = prows[j++];
          if (w.rev)
            put_rev(p, g[w.gid].dna, w.pos, run.k);
          else
            put_fwd(p, g[w.gid].dna, w.pos, run.k);
        } else {
          std::memset(p, '-', static_cast<size_t>(run.k));
        }
      }
      col += run.k;
    }
  }

  static char* put_line_head(char* p, const PLine& l) {
    *p++ = 's';
    *p++ = '\t';
    std::memcpy(p, l.name->data(), l.name->size());
    p += l.name->size();
    *p++ = '\t';
    p = put_int(p, l.start);
    *p++ = '\t';
    p = put_int(p, l.length);
    *p++ = '\t';
    *p++ = l.neg ? '-' : '+';
    *p++ = '\t';
    p = put_int(p, l.src_length);
    *p++ = '\t';
    return p;
  }

  // one planned block at p; returns its end
  char* write_block(char* p, const PBlock& b) {
    *p++ = 'a';
    *p++ = '\n';
    line_dst.clear();
    for (size_t i = b.line0; i < b.line1; ++i) {
      const PLine& l = plines[i];
      p = put_line_head(p, l);
      if (l.prefix >= 0)
        std::memcpy(p, carried[static_cast<size_t>(l.prefix)].data(),
                    static_cast<size_t>(b.prefix_w));
      line_dst.emplace_back(l.slot, p);
      p += b.width;
      *p++ = '\n';
    }
    *p++ = '\n';
    // the reference line prints first; the rest are in slot order
    std::sort(line_dst.begin(), line_dst.end());
    fill_runs(b.run0, b.run1, line_dst, b.prefix_w);
    return p;
  }

  // the block left open at the end of a plan: its runs become staged text
  // (every entry padded), which the next call's plan carries as the
  // block's prefix
  void stage_open_block() {
    line_dst.clear();
    for (size_t i = 0; i < entries.size(); ++i) {
      std::string& t = entries[i]->text;
      size_t n = t.size();
      t.resize(n + static_cast<size_t>(open_cols));
      line_dst.emplace_back(static_cast<int32_t>(i), &t[0] + n);
    }
    fill_runs(open_run0, pruns.size(), line_dst, 0);
    staged_cols += open_cols;
    open_cols = 0;
    pruns.resize(open_run0);
    prows.resize(open_row0);
  }

  void clear_plan() {
    prows.clear();
    pruns.clear();
    plines.clear();
    pblocks.clear();
    carried.clear();
    open_run0 = open_row0 = 0;
    open_cols = open_prefix_w = 0;
    planned_bytes = direct_cols = staged_cols = 0;
    plan_error = false;
  }

  bool any_open() const {
    for (auto& e : entries)
      if (e->start != -1) return true;
    return false;
  }

  // every call runs the block machine between begin_plan and end_plan,
  // then write_planned appends the text.  `started` is recomputed as
  // Python feed() does on entry, and the block the last call left open
  // carries its staged text (open_prefix_w columns) into this plan
  void begin_plan() {
    started = reference != nullptr && any_open();
    clear_plan();
    open_prefix_w =
        entries.empty() ? 0 : static_cast<int64_t>(entries[0]->text.size());
  }

  // stages the block left open; returns the planned text's size, or -1
  int64_t end_plan() {
    stage_open_block();
    return plan_error ? -1 : planned_bytes;
  }

  // ------------------------------------------------------------- feed loop
  // mirror of MafBlockBuilder.feed for one run (maf_io.py:383-407)
  void feed_run(int64_t pos, int64_t width) {
    while (width > 0) {
      if (!started) {
        init_block(pos);
        started = true;
      } else if (!can_append()) {
        flush();
        init_block(pos);
      }
      int64_t budget = append_budget();
      int64_t k = width > budget ? budget : width;
      append_run(k);
      pos += k;
      width -= k;
      if (width > 0) {
        flush();
        started = false;
      }
    }
  }

  int export_window(int64_t gs, int64_t ge) {
    int64_t pos = gs;
    while (pos < ge) {
      run_dfs(pos);
      int64_t run = limit < ge - pos ? limit : ge - pos;
      if (run <= 0) return -1;  // defensive: malformed tables
      int64_t kemit = run;
      if (unique) {
        // leftmost-ref-position canonicality (column.py:797-806,
        // reference isCanonicalOnRef halColumnIterator.cpp:208)
        for (auto& pr : refpos) {
          int64_t p0 = pr.first;
          if (pr.second) {
            if (p0 < pos)
              kemit = 0;
            else if (p0 > pos) {
              int64_t k2 = (p0 - pos) / 2 + 1;
              if (k2 < kemit) kemit = k2;
            }
          } else if (p0 < pos) {
            kemit = 0;
          }
        }
      }
      if (kemit > 0) {
        // rows -> BRows in SequenceLess order, stable (DFS order within key)
        brows.clear();
        brows.reserve(rows.size());
        for (const RowRef& r : rows) {
          const GenomeT& t = g[r.gid];
          int64_t si = t.seq_of(r.pos);
          BRow b;
          b.gid = r.gid;
          b.seq = static_cast<int32_t>(si);
          b.rev = r.rev;
          if (r.rev) {
            b.lo = r.pos - kemit + 1;
            b.hi = r.pos + 1;
          } else {
            b.lo = r.pos;
            b.hi = r.pos + kemit;
          }
          brows.push_back(b);
        }
        std::stable_sort(brows.begin(), brows.end(),
                         [this](const BRow& a, const BRow& b) {
                           int64_t ra = g[a.gid].name_rank;
                           int64_t rb = g[b.gid].name_rank;
                           return ra != rb ? ra < rb : a.seq < b.seq;
                         });
        // empty slices (every row filtered) are never yielded in Python
        // (iter_slices_exact: `if out_rows:`) — skip them here too
        if (!brows.empty()) feed_run(pos, kemit);
      }
      pos += run;
    }
    return 0;
  }

  // --------------------------------------- indel stacks (column.py ports)

  struct StackE {
    int32_t gid;
    int64_t idx, first, last;
    bool rev;
    int64_t cum;
  };

  static inline void seq_span(const int64_t* bounds, int64_t n_seq,
                              int64_t i, int64_t* first, int64_t* last) {
    int64_t s = std::upper_bound(bounds, bounds + n_seq + 1, i) - bounds - 1;
    *first = bounds[s];
    *last = bounds[s + 1] - 1;
  }

  // ColumnDFS._eval_del_site (column.py:513-555)
  bool eval_del_site(int32_t gid, int64_t i, bool o, int64_t cum,
                     StackE* out) {
    const GenomeT& t = g[gid];
    int64_t pi = t.top_parent[i];
    if (pi < 0 || t.parent < 0) return false;
    const GenomeT& pt = g[t.parent];
    bool pori = o ^ (t.top_rev[i] != 0);
    int64_t pfirst, plast, sfirst, slast;
    seq_span(pt.seq_bot, pt.n_seq, pi, &pfirst, &plast);
    seq_span(t.seq_top, t.n_seq, i, &sfirst, &slast);
    int64_t cand;
    if (o ? i == sfirst : i == slast) {
      bool p_is_first = pori ? pi == plast : pi == pfirst;
      bool p_is_last = pori ? pi == pfirst : pi == plast;
      if (!p_is_first)
        cand = pori ? pi + 1 : pi - 1;
      else if (!p_is_last)
        cand = pori ? pi - 1 : pi + 1;
      else
        return false;
    } else {
      int64_t j = o ? i - 1 : i + 1;
      int64_t pj = t.top_parent[j];
      if (pj < 0) return false;
      int64_t lo_i = pi <= pj ? pi : pj;
      int64_t hi_i = pi <= pj ? pj : pi;
      int64_t jf, jl;
      seq_span(pt.seq_bot, pt.n_seq, pj, &jf, &jl);
      if (hi_i != lo_i + 2 || jf != pfirst || jl != plast) return false;
      cand = lo_i + 1;
    }
    if (pt.bot_child != nullptr && pt.n_children > 0) {
      const GenomeT& ct = g[static_cast<size_t>(t.parent)];
      int64_t slot = t.slot_in_parent;
      if (ct.bot_child[cand * ct.n_children + slot] >= 0) return false;
    }
    int64_t lo = pt.bot_start[cand];
    int64_t hi = pt.bot_start[cand + 1];
    if (hi - lo + cum > max_ref_gap) return false;
    out->gid = static_cast<int32_t>(t.parent);
    out->first = lo;
    out->last = hi - 1;
    out->rev = pori;
    return true;
  }

  // ColumnDFS._eval_ins_site (column.py:557-601)
  bool eval_ins_site(int32_t gid, int64_t i, bool o, int64_t cum,
                     StackE* out) {
    const GenomeT& t = g[gid];
    if (t.top_parent[i] < 0) return false;
    int64_t sfirst, slast;
    seq_span(t.seq_top, t.n_seq, i, &sfirst, &slast);
    if (o ? i == sfirst : i == slast) return false;
    int64_t step = o ? -1 : 1;
    int64_t j = i + step;
    if (t.top_parent[j] >= 0) return false;
    int64_t k = j;
    while (true) {
      int64_t nxt = k + step;
      if (nxt < sfirst || nxt > slast || t.top_parent[nxt] >= 0) break;
      k = nxt;
    }
    bool first_iter = o ? j == slast : j == sfirst;
    bool last_iter = o ? k == sfirst : k == slast;
    if (!(first_iter || last_iter)) {
      int64_t b = k + step;
      int64_t pa = t.top_parent[i], pb = t.top_parent[b];
      if (pb < 0) return false;
      const GenomeT& pt = g[t.parent];
      int64_t fa, la, fb, lb;
      seq_span(pt.seq_bot, pt.n_seq, pa, &fa, &la);
      seq_span(pt.seq_bot, pt.n_seq, pb, &fb, &lb);
      int64_t d = pa > pb ? pa - pb : pb - pa;
      if (d == 1) {
      } else if (fa == fb && la == lb &&
                 (pa == fa || pa == la || pb == fb || pb == lb)) {
      } else {
        return false;
      }
    }
    int64_t lo = t.top_start[j];
    int64_t hi = t.top_start[j + 1];
    if (hi - lo + cum > max_ref_gap) return false;
    out->gid = gid;
    out->first = lo;
    out->last = hi - 1;
    out->rev = o;
    return true;
  }

  // ColumnDFS.collect_indels (column.py:603-634): deletions REVERSED then
  // insertions, entry cumulative sizes per fresh stack
  void collect_indels(int64_t run, int64_t cum, std::vector<StackE>* out) {
    std::vector<StackE> dels, inss;
    StackE e;
    for (const Site& s : del_sites) {
      if (s.rem != run) continue;
      if (eval_del_site(s.gid, s.i, s.o, cum, &e)) {
        e.cum = dels.empty() ? 0
                             : dels.back().cum +
                                   (dels.back().last - dels.back().first + 1);
        e.idx = e.rev ? e.last : e.first;
        dels.push_back(e);
      }
    }
    for (const Site& s : ins_sites) {
      if (s.rem != run) continue;
      if (eval_ins_site(s.gid, s.i, s.o, cum, &e)) {
        e.cum = inss.empty() ? 0
                             : inss.back().cum +
                                   (inss.back().last - inss.back().first + 1);
        e.idx = e.rev ? e.last : e.first;
        inss.push_back(e);
      }
    }
    for (auto it = dels.rbegin(); it != dels.rend(); ++it) out->push_back(*it);
    for (const StackE& s : inss) out->push_back(s);
  }

  // iter_slices_exact._filter_and_record (column.py:704-719): build brows
  // from `rows` over k columns, drop rows fully covered by the visit
  // cache, record this run's visits for the live genomes.  Returns true
  // when any row survived.
  bool make_filtered_brows(int64_t k, const std::set<int32_t>& live) {
    brows.clear();
    brows.reserve(rows.size());
    for (const RowRef& r : rows) {
      BRow b;
      b.gid = r.gid;
      b.seq = static_cast<int32_t>(g[r.gid].seq_of(r.pos));
      b.rev = r.rev;
      if (r.rev) {
        b.lo = r.pos - k + 1;
        b.hi = r.pos + 1;
      } else {
        b.lo = r.pos;
        b.hi = r.pos + k;
      }
      auto it = visit.find(r.gid);
      if (it != visit.end() && it->second.covers(b.lo, b.hi)) continue;
      brows.push_back(b);
    }
    std::stable_sort(brows.begin(), brows.end(),
                     [this](const BRow& a, const BRow& b) {
                       int64_t ra = g[a.gid].name_rank;
                       int64_t rb = g[b.gid].name_rank;
                       return ra != rb ? ra < rb : a.seq < b.seq;
                     });
    for (const RowRef& v : visits) {
      if (!live.count(v.gid)) continue;
      PosCache& pc = visit[v.gid];
      if (v.rev)
        pc.add(v.pos - k + 1, v.pos + 1);
      else
        pc.add(v.pos, v.pos + k);
    }
    return !brows.empty();
  }

  // iter_slices_exact with max_ref_gap > 0 (column.py:721-816)
  int export_window_indel(int64_t gs, int64_t ge) {
    track_visits = true;
    visit.clear();
    std::vector<StackE> stack;
    int64_t pos = gs;
    while (pos < ge || !stack.empty()) {
      if (!stack.empty()) {
        StackE& e = stack.back();
        auto vit = visit.find(e.gid);
        if (vit != visit.end()) {
          int64_t idx = e.idx, lo, hi;
          while (idx <= e.last && vit->second.interval_at(idx, &lo, &hi))
            idx = hi;  // nextFreeIndex (column.py:726-737)
          e.idx = idx;
          if (idx < e.first || idx > e.last) {
            stack.pop_back();
            continue;
          }
        }
        run_from(e.gid, e.idx, e.rev);
        int64_t remaining = e.rev ? e.idx - e.first + 1 : e.last - e.idx + 1;
        int64_t run = limit < remaining ? limit : remaining;
        if (run <= 0) return -1;
        if (vit != visit.end()) {
          int64_t fr = vit->second.free_run(e.idx, !e.rev);
          if (fr < run) run = fr;
        }
        std::set<int32_t> live;
        live.insert(ref);
        for (const StackE& s : stack) live.insert(s.gid);
        if (make_filtered_brows(run, live)) feed_run(pos, run);
        std::vector<StackE> subs;
        if (stack.size() < 64) collect_indels(run, e.cum, &subs);
        // e may dangle after push_back — update via index
        size_t ei = stack.size() - 1;
        stack[ei].idx = stack[ei].rev ? stack[ei].idx - run
                                      : stack[ei].idx + run;
        bool done = stack[ei].rev ? stack[ei].idx < stack[ei].first
                                  : stack[ei].idx > stack[ei].last;
        if (done) stack.erase(stack.begin() + ei);
        for (const StackE& s : subs) stack.push_back(s);
        continue;
      }
      run_from(ref, pos, false);
      int64_t run = limit < ge - pos ? limit : ge - pos;
      if (run <= 0) return -1;
      int64_t kemit = run;
      if (unique) {
        for (auto& pr : refpos) {
          int64_t p0 = pr.first;
          if (pr.second) {
            if (p0 < pos)
              kemit = 0;
            else if (p0 > pos) {
              int64_t k2 = (p0 - pos) / 2 + 1;
              if (k2 < kemit) kemit = k2;
            }
          } else if (p0 < pos) {
            kemit = 0;
          }
        }
      }
      if (kemit > 0) {
        // rows built over kemit columns, visits recorded over the RUN
        // (column.py:807-812 passes run to _filter_and_record)
        std::set<int32_t> live;
        live.insert(ref);
        // build rows at kemit width, then record at run width: mirror by
        // temporarily building brows at kemit and recording separately
        brows.clear();
        for (const RowRef& r : rows) {
          BRow b;
          b.gid = r.gid;
          b.seq = static_cast<int32_t>(g[r.gid].seq_of(r.pos));
          b.rev = r.rev;
          if (r.rev) {
            b.lo = r.pos - kemit + 1;
            b.hi = r.pos + 1;
          } else {
            b.lo = r.pos;
            b.hi = r.pos + kemit;
          }
          auto it = visit.find(r.gid);
          if (it != visit.end() && it->second.covers(b.lo, b.hi)) continue;
          brows.push_back(b);
        }
        std::stable_sort(brows.begin(), brows.end(),
                         [this](const BRow& a, const BRow& b) {
                           int64_t ra = g[a.gid].name_rank;
                           int64_t rb = g[b.gid].name_rank;
                           return ra != rb ? ra < rb : a.seq < b.seq;
                         });
        for (const RowRef& v : visits) {
          if (v.gid != ref) continue;
          PosCache& pc = visit[v.gid];
          if (v.rev)
            pc.add(v.pos - run + 1, v.pos + 1);
          else
            pc.add(v.pos, v.pos + run);
        }
        if (!brows.empty()) feed_run(pos, kemit);
      }
      std::vector<StackE> subs;
      collect_indels(run, 0, &subs);
      for (const StackE& s : subs) stack.push_back(s);
      pos += run;
    }
    return 0;
  }

  // iter_slices_exact shared_visit branch (column.py:756-796) — one
  // --global pass for the current ref; shared_visit persists across refs
  int export_window_global(int64_t gs, int64_t ge) {
    track_visits = true;
    int64_t pos = gs;
    std::vector<char> bad;
    while (pos < ge) {
      run_from(ref, pos, false);
      int64_t run = limit < ge - pos ? limit : ge - pos;
      if (run <= 0) return -1;
      int64_t k = run;
      bad.assign(static_cast<size_t>(k), 0);
      for (const RowRef& v : visits) {
        auto it = shared_visit.find(v.gid);
        if (it == shared_visit.end()) continue;
        int64_t vlo = v.rev ? v.pos - k + 1 : v.pos;
        int64_t vhi = v.rev ? v.pos + 1 : v.pos + k;
        it->second.overlaps(vlo, vhi, [&](int64_t a, int64_t b) {
          int64_t o0 = v.rev ? v.pos - b + 1 : a - v.pos;
          int64_t o1 = v.rev ? v.pos - a + 1 : b - v.pos;
          for (int64_t x = o0; x < o1; ++x) bad[static_cast<size_t>(x)] = 1;
        });
      }
      PosCache& pc = shared_visit[ref];
      for (const RowRef& v : visits) {
        if (v.gid != ref) continue;
        if (v.rev)
          pc.add(v.pos - k + 1, v.pos + 1);
        else
          pc.add(v.pos, v.pos + k);
      }
      int64_t o = 0;
      while (o < k) {
        if (bad[static_cast<size_t>(o)]) {
          ++o;
          continue;
        }
        int64_t o1 = o;
        while (o1 < k && !bad[static_cast<size_t>(o1)]) ++o1;
        brows.clear();
        for (const RowRef& r : rows) {
          int64_t p2 = r.rev ? r.pos - o : r.pos + o;
          BRow b;
          b.gid = r.gid;
          b.seq = static_cast<int32_t>(g[r.gid].seq_of(p2));
          b.rev = r.rev;
          if (r.rev) {
            b.lo = p2 - (o1 - o) + 1;
            b.hi = p2 + 1;
          } else {
            b.lo = p2;
            b.hi = p2 + (o1 - o);
          }
          brows.push_back(b);
        }
        std::stable_sort(brows.begin(), brows.end(),
                         [this](const BRow& a, const BRow& b) {
                           int64_t ra = g[a.gid].name_rank;
                           int64_t rb = g[b.gid].name_rank;
                           return ra != rb ? ra < rb : a.seq < b.seq;
                         });
        if (!brows.empty()) feed_run(pos + o, o1 - o);
        o = o1;
      }
      pos += run;
    }
    return 0;
  }

  // ---------------------------------------------------- fragment assembler
  // Consumer for the DEVICE column engine (ops/column_torch.py): fragments
  // arrive sorted by global row precedence (genome name rank, sequence,
  // DFS program ordinal, DFS key) and pre-filtered, with each one's
  // sequence; `cuts` holds every fragment start and end in the window.
  // plan_frags cuts them into atomic slices and drives the same block
  // machine the DFS path uses, so the bytes match ce_export / the
  // exact-Python path for the covered flag surface.
  void plan_frags(int64_t n_frag, const int64_t* fs_lo,
                  const int64_t* ft_lo, const int64_t* fln,
                  const uint8_t* frev, const int64_t* fgid,
                  const int64_t* fseq, int64_t n_cuts, const int64_t* cuts) {
    // cover: interval ci = [cuts[ci], cuts[ci + 1]) holds fragment f when
    // f starts at or before it and ends after its start; counting, a
    // prefix sum and a fill in fragment order leave each interval's rows
    // in precedence order.  Within a sequence of a program fragments come
    // in key order, mostly in source order too, so each search starts at
    // the last one's cut.
    int64_t n_iv = n_cuts > 1 ? n_cuts - 1 : 0;
    auto cover = [&](auto&& fn) {  // fn(f, ci) for each interval ci of f
      int64_t a = 0;
      for (int64_t f = 0; f < n_frag; ++f) {
        a = a < n_cuts && cuts[a] < fs_lo[f]
                ? gallop(cuts, n_cuts, a, fs_lo[f])
                : std::lower_bound(cuts, cuts + a, fs_lo[f]) - cuts;
        int64_t b = gallop(cuts, n_cuts, a, fs_lo[f] + fln[f]);
        for (int64_t ci = a; ci < b && ci < n_iv; ++ci) fn(f, ci);
      }
    };
    std::vector<int64_t> at(static_cast<size_t>(n_iv) + 1, 0);
    cover([&](int64_t, int64_t ci) { ++at[static_cast<size_t>(ci) + 1]; });
    for (int64_t ci = 0; ci < n_iv; ++ci)
      at[static_cast<size_t>(ci) + 1] += at[static_cast<size_t>(ci)];
    std::vector<int64_t> rows_of(static_cast<size_t>(at.back()));
    std::vector<int64_t> fill(at.begin(), at.end() - 1);
    cover([&](int64_t f, int64_t ci) {
      rows_of[static_cast<size_t>(fill[static_cast<size_t>(ci)]++)] = f;
    });
    // room for the plan: a run a non-empty interval, a row and a line a
    // row, more where --maxBlockLen cuts an interval
    size_t n_rows = rows_of.size();
    prows.reserve(n_rows + n_rows / 8);
    pruns.reserve(static_cast<size_t>(n_iv) + static_cast<size_t>(n_iv) / 8);
    plines.reserve(n_rows + n_rows / 8);
    pblocks.reserve(static_cast<size_t>(n_iv));
    for (int64_t ci = 0; ci < n_iv; ++ci) {
      int64_t a = cuts[ci], b = cuts[ci + 1];
      size_t r0 = static_cast<size_t>(at[static_cast<size_t>(ci)]);
      size_t r1 = static_cast<size_t>(at[static_cast<size_t>(ci) + 1]);
      if (b <= a || r0 == r1) continue;
      brows.clear();
      for (size_t j = r0; j < r1; ++j) {
        int64_t fi = rows_of[j];
        BRow r;
        r.gid = static_cast<int32_t>(fgid[fi]);
        r.seq = static_cast<int32_t>(fseq[fi]);
        r.rev = frev[fi];
        int64_t adv = a - fs_lo[fi];
        if (r.rev) {
          r.hi = ft_lo[fi] + fln[fi] - adv;
          r.lo = r.hi - (b - a);
        } else {
          r.lo = ft_lo[fi] + adv;
          r.hi = r.lo + (b - a);
        }
        brows.push_back(r);
      }
      feed_run(a, b - a);
    }
  }

  // the planned blocks' text, each block at its offset in one exact-size
  // extension of `out`; returns out's size, or -1
  int64_t write_planned() {
    size_t base = out.size();
    out.resize(base + static_cast<size_t>(planned_bytes));
    char* o = &out[0] + base;
    bool ok = true;
    for (const PBlock& b : pblocks)
      ok = write_block(o + b.off, b) == o + b.off + b.bytes && ok;
    clear_plan();
    return ok ? static_cast<int64_t>(out.size()) : -1;
  }

  void finish() {  // flush_end (maf_io.py:409-416)
    if (any_open()) {
      flush();
      reset_entries();
    }
  }
};

}  // namespace

extern "C" {

void* ce_new(int64_t n_genomes, int64_t ref_gid, int64_t flags,
             int64_t max_block_len) {
  Engine* e = new Engine();
  e->g.resize(static_cast<size_t>(n_genomes));
  e->ref = static_cast<int32_t>(ref_gid);
  e->no_dupes = flags & 1;
  e->no_ancestors = flags & 2;
  e->only_orthologs = flags & 4;
  e->unique = flags & 8;
  e->has_scope = flags & 16;
  e->has_targets = flags & 32;
  e->keep_empty_ref_blocks = (flags & 64) == 0;
  e->max_len = max_block_len > 0 ? max_block_len : 1000;
  return e;
}

void ce_add_genome(void* h, int64_t gid, const char* name, int64_t parent_gid,
                   int64_t slot_in_parent, int64_t n_children,
                   const int64_t* child_gids, int64_t n_seq,
                   const int64_t* seq_start, const int64_t* seq_top,
                   const int64_t* seq_bot, const char* seq_names_blob,
                   int64_t n_top, const int64_t* top_start,
                   const int64_t* top_parent, const uint8_t* top_rev,
                   const int64_t* top_para, const int64_t* top_bparse,
                   int64_t n_bot, const int64_t* bot_start,
                   const int64_t* bot_tparse, const int64_t* bot_child,
                   const uint8_t* bot_crev, const uint8_t* dna_packed,
                   int64_t name_rank, int64_t in_scope, int64_t is_target,
                   int64_t is_leaf) {
  Engine* e = static_cast<Engine*>(h);
  GenomeT& t = e->g[static_cast<size_t>(gid)];
  t.name = name;
  t.parent = parent_gid;
  t.slot_in_parent = slot_in_parent;
  t.n_children = n_children;
  t.children.assign(child_gids, child_gids + n_children);
  t.n_seq = n_seq;
  t.seq_start = seq_start;
  t.seq_top = seq_top;
  t.seq_bot = seq_bot;
  t.seq_names.clear();
  const char* p = seq_names_blob;
  for (int64_t i = 0; i < n_seq; ++i) {
    t.seq_names.emplace_back(p);
    p += t.seq_names.back().size() + 1;
  }
  t.n_top = n_top;
  t.top_start = top_start;
  t.top_parent = top_parent;
  t.top_rev = top_rev;
  t.top_para = top_para;
  t.top_bparse = top_bparse;
  t.n_bot = n_bot;
  t.bot_start = bot_start;
  t.bot_tparse = bot_tparse;
  t.bot_child = bot_child;
  t.bot_crev = bot_crev;
  t.dna = dna_packed;
  t.name_rank = name_rank;
  t.in_scope = in_scope != 0;
  t.is_target = is_target != 0;
  t.is_leaf = is_leaf != 0;
}

// ce_export and ce_finish return out's size, or -1
int64_t ce_export(void* h, int64_t gs, int64_t ge) {
  Engine* e = static_cast<Engine*>(h);
  e->begin_plan();
  int rc;
  if (e->global_mode)
    rc = e->export_window_global(gs, ge);
  else if (e->max_ref_gap > 0)
    rc = e->export_window_indel(gs, ge);
  else
    rc = e->export_window(gs, ge);
  if (e->end_plan() < 0 || rc != 0) return -1;
  return e->write_planned();
}

void ce_set_opts(void* h, int64_t max_ref_gap, int64_t global_mode) {
  Engine* e = static_cast<Engine*>(h);
  e->max_ref_gap = max_ref_gap;
  e->global_mode = global_mode != 0;
  e->track_visits = e->max_ref_gap > 0 || e->global_mode;
}

// --global: re-target the engine to a new reference genome, resetting the
// block machine (the Python exporter builds a fresh MafBlockBuilder per
// ref pass, halMafExport.cpp:90-160) while shared_visit persists
void ce_set_ref(void* h, int64_t ref_gid) {
  Engine* e = static_cast<Engine*>(h);
  e->ref = static_cast<int32_t>(ref_gid);
  e->entries.clear();
  e->reference = nullptr;
  e->ref_index = -1;
  e->started = false;
}

// the fragment assembler's plan: returns the exact size of the text that
// ce_write_frags will add (or -1), and in cols[0], cols[1] the columns fed
// to blocks that closed in this call (written directly) and to the block
// left open (staged for the next call or ce_finish)
int64_t ce_plan_frags(void* h, int64_t n_frag, const int64_t* s_lo,
                      const int64_t* t_lo, const int64_t* ln,
                      const uint8_t* rev, const int64_t* gid,
                      const int64_t* seq, int64_t n_cuts, const int64_t* cuts,
                      int64_t* cols) {
  Engine* e = static_cast<Engine*>(h);
  e->begin_plan();
  e->plan_frags(n_frag, s_lo, t_lo, ln, rev, gid, seq, n_cuts, cuts);
  int64_t n = e->end_plan();
  cols[0] = e->direct_cols;
  cols[1] = e->staged_cols;
  return n;
}

// writes the last plan's text after what `out` holds; returns its size
int64_t ce_write_frags(void* h) {
  return static_cast<Engine*>(h)->write_planned();
}

int64_t ce_finish(void* h) {
  Engine* e = static_cast<Engine*>(h);
  e->begin_plan();
  e->finish();
  if (e->end_plan() < 0) return -1;
  return e->write_planned();
}

// zero-extra-copy drain: expose the buffer, then consume
const char* ce_data(void* h, int64_t* n) {
  Engine* e = static_cast<Engine*>(h);
  *n = static_cast<int64_t>(e->out.size());
  return e->out.data();
}

void ce_consume(void* h, int64_t n) {
  Engine* e = static_cast<Engine*>(h);
  e->out.erase(0, static_cast<size_t>(n));
}

void ce_free(void* h) { delete static_cast<Engine*>(h); }

}  // extern "C"
