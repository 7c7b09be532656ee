// Helpers shared by every library built from csrc.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace repro {

// Runs fn(std::integral_constant<bool, b>) so that a runtime flag picks a
// template instantiation.
template <typename F>
inline int with_flag(bool b, F&& fn) {
  return b ? fn(std::true_type{}) : fn(std::false_type{});
}

}  // namespace repro

// The message for an error code that a launch function returned.
extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
