// A block of one thread: the `Block` of the arithmetic that the kernels
// write once for a block (chimera_tpu_torch/csrc/kde.cuh, adjoint.cuh), for
// the serial host emulations.  Its block sums, min/max and any are the
// thread's own values; its barrier is nothing.  It is a warp of one lane,
// which keeps every coefficient of the adjoint's projections
// (adjoint.cuh, project).
#pragma once

template <typename T>
struct HostBlock {
  static constexpr int kSize = 1;
  static constexpr int kLanes = 1;
  int rank() const { return 0; }
  int lane() const { return 0; }
  template <int N>
  void sum(T (&)[N]) const {}
  void minmax(T&, T&) const {}
  bool any(bool v) const { return v; }
  void sync() const {}
};
