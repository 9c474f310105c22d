// Native document packer: the host-side hot loop of the port's input
// pipeline (odh_kubeflow_tpu_torch/train/data.py).
//
// Packing variable-length token documents into fixed-shape [rows, S]
// training windows is CPU byte-shuffling on the critical path of every
// training step's host feed. The Python path walks documents piece by
// piece with per-piece numpy slicing; this pass writes each output
// element exactly once and is memory-bandwidth-bound.
//
// Semantics are identical to train/data.py's Python path (its tests
// assert bit-equality): documents are concatenated greedily into rows of
// seq_len, each document piece gets a 1-based segment id that resets per
// row, targets are next-token *within a piece*, and the last token of
// each piece plus all padding carry loss_mask 0.
//
// A plain C ABI loaded with ctypes; the arrays are caller-allocated
// numpy buffers.

#include <cstdint>

extern "C" {

// Returns the number of rows written (<= max_rows), or -1 if the packed
// stream would overflow max_rows. Outputs must hold max_rows*seq_len
// elements each; callers pre-fill tokens/targets with pad_id and
// seg/mask with zero (matching numpy allocation in the wrapper).
long pack_documents_c(const int32_t* flat,      // concatenated tokens
                      const int64_t* doc_lens,  // [n_docs]
                      long n_docs,
                      long seq_len,
                      int32_t* tokens,   // [max_rows, seq_len]
                      int32_t* targets,  // [max_rows, seq_len]
                      int32_t* seg_ids,  // [max_rows, seq_len]
                      float* loss_mask,  // [max_rows, seq_len]
                      long max_rows) {
  long row = 0;       // current row
  long used = 0;      // tokens used in current row
  int32_t seg = 0;    // segment counter within current row
  bool row_open = false;
  const int32_t* cursor = flat;

  for (long d = 0; d < n_docs; ++d) {
    int64_t remaining = doc_lens[d];
    while (remaining > 0) {
      if (used == seq_len) {  // row full: advance
        ++row;
        used = 0;
        seg = 0;
      }
      if (row >= max_rows) return -1;
      row_open = true;
      long space = seq_len - used;
      long n = remaining < space ? static_cast<long>(remaining) : space;
      ++seg;
      int32_t* t = tokens + row * seq_len + used;
      int32_t* tg = targets + row * seq_len + used;
      int32_t* sg = seg_ids + row * seq_len + used;
      float* m = loss_mask + row * seq_len + used;
      for (long i = 0; i < n; ++i) {
        t[i] = cursor[i];
        sg[i] = seg;
      }
      // next-token targets within the piece; last token masked out
      for (long i = 0; i + 1 < n; ++i) {
        tg[i] = cursor[i + 1];
        m[i] = 1.0f;
      }
      cursor += n;
      used += n;
      remaining -= n;
    }
  }
  return row_open ? row + 1 : row;
}

}  // extern "C"
