// Copy of native/coregex_native.cpp for coregex_tpu_torch/native.py, which
// builds it with g++ into coregex_tpu_torch/_build/ at first use.
// coregex-tpu native core: eager DFA determinizer.
//
// Mirrors coregex_tpu/dfa/determinize.py exactly (same priority /
// break-at-match / look-context semantics — see that file for the
// semantics documentation and the reference citations).  Pattern compile
// includes full determinization here (the reference determinizes lazily
// at search time, dfa/lazy/builder.go), so this is the compile-time hot
// path; the Python implementation remains as the fallback and oracle.
//
// C ABI (ctypes-friendly), no Python headers required.

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <unordered_map>
#include <vector>
#include <string>

namespace {

enum Kind { FAIL = 0, MATCH = 1, RANGE = 2, SPLIT = 3, LOOK = 4, CAPTURE = 5 };
enum LookKind {
  BEGIN_TEXT = 0, END_TEXT = 1, BEGIN_LINE = 2, END_LINE = 3,
  WORD_BOUNDARY = 4, NO_WORD_BOUNDARY = 5
};

struct NFAView {
  const int32_t* kinds;       // [S]
  const int32_t* offsets;     // [S+1] into payload
  const int32_t* payload;     // RANGE: lo,hi,next; SPLIT: targets...;
                              // LOOK: look,next; CAPTURE: slot,next
  int32_t n_states;
};

struct Ctx {
  bool prev_word, prev_nl, at_start;
};

// DFA state identity: ordered id list + context flags.
struct Key {
  std::vector<int32_t> ids;
  uint8_t flags;  // bit0 prev_word, bit1 prev_nl, bit2 at_start
  bool operator==(const Key& o) const {
    return flags == o.flags && ids == o.ids;
  }
};

struct KeyHash {
  size_t operator()(const Key& k) const {
    size_t h = 1469598103934665603ull ^ k.flags;
    for (int32_t v : k.ids) {
      h ^= (size_t)v;
      h *= 1099511628211ull;
    }
    return h;
  }
};

struct Determinizer {
  NFAView nfa;
  bool anchored, break_at_match, needs_prev;
  int state_limit;
  int num_classes;
  std::vector<uint8_t> cls_word, cls_nl;  // [C]

  std::unordered_map<Key, int32_t, KeyHash> interned;
  std::vector<Key> sets;
  bool overflow = false;

  // scratch
  std::vector<int32_t> stack;
  std::vector<uint8_t> visited;  // [S], generation-free (cleared per call)

  int kind(int32_t s) const { return nfa.kinds[s]; }
  const int32_t* pay(int32_t s) const { return nfa.payload + nfa.offsets[s]; }
  int paylen(int32_t s) const { return nfa.offsets[s + 1] - nfa.offsets[s]; }

  // epsilon closure, prev context known, next unknown
  void closure(const std::vector<int32_t>& roots, const Ctx& c,
               std::vector<int32_t>& out) {
    out.clear();
    stack.clear();
    std::fill(visited.begin(), visited.end(), 0);
    for (auto it = roots.rbegin(); it != roots.rend(); ++it)
      stack.push_back(*it);
    while (!stack.empty()) {
      int32_t sid = stack.back();
      stack.pop_back();
      if (visited[sid]) continue;
      visited[sid] = 1;
      switch (kind(sid)) {
        case RANGE:
        case MATCH:
          out.push_back(sid);
          break;
        case SPLIT: {
          const int32_t* p = pay(sid);
          int np = paylen(sid);
          for (int i = np - 1; i >= 0; --i) stack.push_back(p[i]);
          break;
        }
        case CAPTURE:
          stack.push_back(pay(sid)[1]);
          break;
        case LOOK: {
          int look = pay(sid)[0];
          if (look == BEGIN_TEXT) {
            if (c.at_start) stack.push_back(pay(sid)[1]);
          } else if (look == BEGIN_LINE) {
            if (c.at_start || c.prev_nl) stack.push_back(pay(sid)[1]);
          } else {
            out.push_back(sid);  // next-dependent: keep unresolved
          }
          break;
        }
        default:
          break;  // FAIL
      }
    }
  }

  // full closure when both prev and next are known (look resolution)
  void closure_full(int32_t root, const Ctx& c, bool next_word, bool next_nl,
                    bool at_eoi, std::vector<int32_t>& out,
                    std::vector<uint8_t>& emitted,
                    std::vector<uint8_t>& vis2) {
    std::vector<int32_t> st;
    st.push_back(root);
    while (!st.empty()) {
      int32_t sid = st.back();
      st.pop_back();
      if (vis2[sid]) continue;
      vis2[sid] = 1;
      switch (kind(sid)) {
        case RANGE:
        case MATCH:
          if (!emitted[sid]) {
            emitted[sid] = 1;
            out.push_back(sid);
          }
          break;
        case SPLIT: {
          const int32_t* p = pay(sid);
          int np = paylen(sid);
          for (int i = np - 1; i >= 0; --i) st.push_back(p[i]);
          break;
        }
        case CAPTURE:
          st.push_back(pay(sid)[1]);
          break;
        case LOOK: {
          int look = pay(sid)[0];
          bool ok = false;
          switch (look) {
            case BEGIN_TEXT: ok = c.at_start; break;
            case BEGIN_LINE: ok = c.at_start || c.prev_nl; break;
            case END_TEXT: ok = at_eoi; break;
            case END_LINE: ok = at_eoi || next_nl; break;
            case WORD_BOUNDARY: ok = c.prev_word != next_word; break;
            case NO_WORD_BOUNDARY: ok = c.prev_word == next_word; break;
          }
          if (ok) st.push_back(pay(sid)[1]);
          break;
        }
        default:
          break;
      }
    }
  }

  // transition: cls < 0 means window edge with eoi_ctx in {0..3}
  // returns next dense id (0 = DEAD); *is_match set
  int32_t transition(const Key& key, int cls, int eoi_ctx, bool* is_match) {
    Ctx c{(key.flags & 1) != 0, (key.flags & 2) != 0, (key.flags & 4) != 0};
    bool at_edge = cls < 0;
    bool at_eoi, next_word, next_nl;
    if (at_edge) {
      at_eoi = eoi_ctx == 0;
      next_word = eoi_ctx == 1;
      next_nl = eoi_ctx == 2;
    } else {
      at_eoi = false;
      next_word = cls_word[cls] != 0;
      next_nl = cls_nl[cls] != 0;
    }

    std::vector<int32_t> resolved;
    std::vector<uint8_t> emitted(nfa.n_states, 0);
    std::vector<uint8_t> vis2(nfa.n_states, 0);
    bool matched = false;
    for (int32_t sid : key.ids) {
      if (matched && break_at_match) break;
      int k = kind(sid);
      if (k == MATCH) {
        matched = true;
      } else if (k == RANGE) {
        if (!emitted[sid]) {
          emitted[sid] = 1;
          resolved.push_back(sid);
        }
      } else if (k == LOOK) {
        int look = pay(sid)[0];
        bool ok = false;
        switch (look) {
          case END_TEXT: ok = at_eoi; break;
          case END_LINE: ok = at_eoi || next_nl; break;
          case WORD_BOUNDARY: ok = c.prev_word != next_word; break;
          case NO_WORD_BOUNDARY: ok = c.prev_word == next_word; break;
        }
        if (ok) {
          size_t before = resolved.size();
          closure_full(pay(sid)[1], c, next_word, next_nl, at_eoi,
                       resolved, emitted, vis2);
          // handle MATCH ids emitted by the closure, in order
          std::vector<int32_t> kept;
          for (size_t i = before; i < resolved.size(); ++i) {
            int32_t rid = resolved[i];
            if (matched && break_at_match) break;
            if (kind(rid) == MATCH)
              matched = true;
            else
              kept.push_back(rid);
          }
          resolved.resize(before);
          for (int32_t r : kept) resolved.push_back(r);
        }
      }
    }
    *is_match = matched;
    if (at_edge) return 0;

    // step on the byte class: representative byte per class supplied via
    // the rep table below (set in run())
    std::vector<int32_t> targets;
    for (int32_t sid : resolved) {
      const int32_t* p = pay(sid);
      int b = rep[cls];
      if (p[0] <= b && b <= p[1]) targets.push_back(p[2]);
    }
    Ctx nc{next_word, next_nl, false};
    std::vector<int32_t> new_ids;
    closure(targets, nc, new_ids);
    if (new_ids.empty()) return 0;
    Key nk;
    nk.ids = std::move(new_ids);
    nk.flags = 0;
    if (needs_prev) {
      if (next_word) nk.flags |= 1;
      if (next_nl) nk.flags |= 2;
    }
    return intern(nk);
  }

  std::vector<int32_t> rep;  // [C] representative byte per class

  int32_t intern(Key& k) {
    auto it = interned.find(k);
    if (it != interned.end()) return it->second;
    int32_t id = (int32_t)sets.size();
    if (id > state_limit) {
      overflow = true;
      return 0;
    }
    interned.emplace(k, id);
    sets.push_back(k);
    return id;
  }
};

}  // namespace

extern "C" {

// Returns 0 on success, 1 on overflow, 2 on bad input.
// Outputs are malloc'd; caller frees with crx_free.
int crx_determinize(
    const int32_t* kinds, const int32_t* offsets, const int32_t* payload,
    int32_t n_states, int32_t start_anchored, int32_t start_unanchored,
    const int32_t* classes256, int32_t num_classes,
    int32_t anchored, int32_t break_at_match, int32_t state_limit,
    int32_t needs_prev, int32_t needs_word, int32_t needs_nl,
    int32_t** delta_out, uint8_t** match_out, uint8_t** eoi_out,
    int32_t* starts_out, int32_t* n_dfa_out) {
  Determinizer d;
  d.nfa = NFAView{kinds, offsets, payload, n_states};
  d.anchored = anchored != 0;
  d.break_at_match = break_at_match != 0;
  d.state_limit = state_limit;
  d.num_classes = num_classes;
  d.needs_prev = needs_prev != 0;
  d.visited.resize(n_states, 0);

  // representative byte + class flags
  d.rep.assign(num_classes, 256);
  d.cls_word.assign(num_classes, 0);
  d.cls_nl.assign(num_classes, 0);
  for (int b = 255; b >= 0; --b) d.rep[classes256[b]] = b;
  auto is_word = [](int b) {
    return (b >= '0' && b <= '9') || (b >= 'A' && b <= 'Z') || b == '_' ||
           (b >= 'a' && b <= 'z');
  };
  for (int c = 0; c < num_classes; ++c) {
    int b = d.rep[c];
    if (b <= 255) {
      d.cls_word[c] = is_word(b) ? 1 : 0;
      d.cls_nl[c] = (b == 10) ? 1 : 0;
    }
  }

  // dead state 0
  Key dead;
  dead.flags = 0;
  d.interned.emplace(dead, 0);
  d.sets.push_back(dead);

  // start states per context: SOT, word, nl, other
  const bool ctxs[4][3] = {
      {false, false, true}, {true, false, false},
      {false, true, false}, {false, false, false}};
  int32_t start_nfa = anchored ? start_anchored : start_unanchored;
  for (int i = 0; i < 4; ++i) {
    Ctx c{ctxs[i][0], ctxs[i][1], ctxs[i][2]};
    std::vector<int32_t> ids;
    std::vector<int32_t> roots{start_nfa};
    d.closure(roots, c, ids);
    if (ids.empty()) {
      starts_out[i] = 0;
      continue;
    }
    Key k;
    k.ids = std::move(ids);
    k.flags = 0;
    if (d.needs_prev) {
      if (c.prev_word) k.flags |= 1;
      if (c.prev_nl) k.flags |= 2;
      if (c.at_start) k.flags |= 4;
    } else if (c.at_start) {
      k.flags |= 4;
    }
    starts_out[i] = d.intern(k);
  }

  // build rows breadth-first (sets grows during iteration)
  std::vector<int32_t> delta;
  std::vector<uint8_t> match;
  std::vector<uint8_t> eoi;
  for (size_t i = 0; i < d.sets.size(); ++i) {
    Key key = d.sets[i];  // copy: sets may reallocate
    size_t base = delta.size();
    delta.resize(base + num_classes, 0);
    match.resize(base + num_classes, 0);
    eoi.resize(i * 4 + 4, 0);
    if (!key.ids.empty()) {
      for (int c2 = 0; c2 < num_classes; ++c2) {
        bool m = false;
        int32_t nxt = d.transition(key, c2, 0, &m);
        if (d.overflow) return 1;
        delta[base + c2] = nxt;
        match[base + c2] = m ? 1 : 0;
      }
      for (int ctx = 0; ctx < 4; ++ctx) {
        bool m = false;
        d.transition(key, -1, ctx, &m);
        eoi[i * 4 + ctx] = m ? 1 : 0;
      }
    }
  }

  int32_t S = (int32_t)d.sets.size();
  *n_dfa_out = S;
  *delta_out = (int32_t*)malloc(sizeof(int32_t) * S * num_classes);
  *match_out = (uint8_t*)malloc(S * num_classes);
  *eoi_out = (uint8_t*)malloc(S * 4);
  memcpy(*delta_out, delta.data(), sizeof(int32_t) * S * num_classes);
  memcpy(*match_out, match.data(), S * num_classes);
  memcpy(*eoi_out, eoi.data(), S * 4);
  return 0;
}

void crx_free(void* p) { free(p); }

int crx_version() { return 1; }

}  // extern "C"
