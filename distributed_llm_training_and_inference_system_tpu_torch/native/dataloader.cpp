// Native sequence packer: the dataloader hot path (the port's copy of the
// JAX package's native/dataloader.cpp, unchanged below this comment).
//
// The per-batch packing loop (walking permuted documents out of
// memory-mapped token shards into fixed [B, S] rows with segment ids and
// restarting positions) runs in C++ through a narrow C ABI loaded with
// ctypes. Semantics are EXACTLY those of the numpy packer in io/data.py
// (held token for token by tests/test_torch_native.py), including carry of
// document tails across rows and batches, pack=false row isolation, and
// drop_tail truncation.
//
// Epoch wraps stay in Python: when the permuted order is exhausted
// mid-batch the packer returns 1 with its full progress in PackState;
// Python re-permutes (seeded RNG) and resumes the same batch.
//
// Build: g++ -O3 -shared -fPIC dataloader.cpp -o dataloader.so
// (io/native.py compiles it at first use into build/native/ at the root
// of the checkout, never beside this file).

#include <cstdint>
#include <cstring>

extern "C" {

struct PackState {
  int64_t row;      // current batch row
  int64_t fill;     // tokens already in the current row
  int32_t seg;      // next segment id within the current row (1-based)
  int64_t cursor;   // index into order[]
};

// shard_itemsize: bytes per token in each shard (2 = uint16, 4 = uint32).
// doc_table: [ndocs * 3] int64 (shard_idx, start, end) in token units.
// carry: caller-owned int32 buffer of capacity carry_cap holding a pending
// document tail; *carry_len is its live length (in/out).
// Returns 0 = batch complete, 1 = order exhausted (re-permute and call
// again), -1 = carry overflow (caller bug: cap < longest document).
int64_t llmctl_pack_continue(
    const uint64_t* shard_ptrs, const int32_t* shard_itemsize,
    const int64_t* doc_table,
    const int64_t* order, int64_t order_len,
    int32_t* tokens, int32_t* segs, int32_t* pos,
    int64_t B, int64_t S,
    int32_t pack, int32_t drop_tail,
    int32_t* carry, int64_t carry_cap, int64_t* carry_len,
    PackState* st) {
  while (st->row < B) {
    while (st->fill < S) {
      int64_t base = st->row * S + st->fill;
      int64_t room = S - st->fill;

      if (*carry_len > 0) {             // resume a carried document tail
        int64_t len = *carry_len;
        int64_t take = len < room ? len : room;
        std::memcpy(tokens + base, carry, take * sizeof(int32_t));
        for (int64_t i = 0; i < take; ++i) {
          segs[base + i] = st->seg;
          pos[base + i] = (int32_t)i;
        }
        if (take < len && !drop_tail) {
          std::memmove(carry, carry + take, (len - take) * sizeof(int32_t));
          *carry_len = len - take;
        } else {
          *carry_len = 0;
        }
        st->fill += take;
        st->seg += 1;
        continue;
      }

      if (st->cursor >= order_len) return 1;   // epoch boundary mid-batch
      if (!pack && st->fill > 0) break;        // one document per row
      int64_t d = order[st->cursor];
      st->cursor += 1;
      int64_t shard = doc_table[d * 3];
      int64_t start = doc_table[d * 3 + 1];
      int64_t len = doc_table[d * 3 + 2] - start;
      int64_t take = len < room ? len : room;

      if (shard_itemsize[shard] == 2) {
        const uint16_t* src =
            reinterpret_cast<const uint16_t*>(shard_ptrs[shard]) + start;
        for (int64_t i = 0; i < take; ++i) tokens[base + i] = (int32_t)src[i];
        if (take < len && !drop_tail) {
          if (len - take > carry_cap) return -1;
          for (int64_t i = 0; i < len - take; ++i)
            carry[i] = (int32_t)src[take + i];
          *carry_len = len - take;
        }
      } else {
        const uint32_t* src =
            reinterpret_cast<const uint32_t*>(shard_ptrs[shard]) + start;
        for (int64_t i = 0; i < take; ++i) tokens[base + i] = (int32_t)src[i];
        if (take < len && !drop_tail) {
          if (len - take > carry_cap) return -1;
          for (int64_t i = 0; i < len - take; ++i)
            carry[i] = (int32_t)src[take + i];
          *carry_len = len - take;
        }
      }
      for (int64_t i = 0; i < take; ++i) {
        segs[base + i] = st->seg;
        pos[base + i] = (int32_t)i;
      }
      st->fill += take;
      st->seg += 1;
    }
    st->row += 1;
    st->fill = 0;
    st->seg = 1;
  }
  return 0;
}

}  // extern "C"
