// A block of one thread: the `Block` of the arithmetic that the kernels
// write once for a block (chimera_tpu_torch/csrc/kde.cuh, adjoint.cuh), for
// the serial host emulations.  Its block sums, min/max and any are the
// thread's own values; its barrier is nothing.  It is a warp of one lane,
// which keeps every coefficient of the adjoint's projections
// (adjoint.cuh, project), whose min/max and span are its own and whose
// ballot is its own bit.  Where `tally` is given, `tile` counts the tiles
// that the pruned pair loops (kde.cuh, contract_pruned; adjoint.cuh,
// rows_adjoint_event, slot_pair_sums) test, in tally[0], and skip, in
// tally[1].
#pragma once

template <typename T>
struct HostBlock {
  static constexpr int kSize = 1;
  static constexpr int kLanes = 1;
  long long* tally = nullptr;
  int rank() const { return 0; }
  int lane() const { return 0; }
  template <int N>
  void sum(T (&)[N]) const {}
  void minmax(T&, T&) const {}
  bool any(bool v) const { return v; }
  void sync() const {}
  void warp_minmax(T&, T&) const {}
  unsigned ballot(bool v) const { return v ? 1u : 0u; }
  void warp_span(int&, int&) const {}
  void tile(bool skipped) const {
    if (tally != nullptr) {
      ++tally[0];
      tally[1] += skipped;
    }
  }
};
