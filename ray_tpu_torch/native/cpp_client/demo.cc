// Demo driver for the C++ client: KV round-trip + cross-language task
// calls into Python functions (see tests/test_cpp_client.py).
//
// Usage: demo <cluster-address>

#include <cstdio>
#include <string>

#include "ray_tpu_client.hpp"

int main(int argc, char** argv) {
  if (argc < 2) {
    std::fprintf(stderr, "usage: %s <address>\n", argv[0]);
    return 2;
  }
  try {
    ray_tpu_torch::Client client(argv[1]);
    std::printf("connected session=%s\n", client.session().c_str());

    // KV round-trip.
    client.kv_put("cpp_key", "cpp_value", "demo");
    std::string back;
    if (!client.kv_get("cpp_key", &back, "demo") || back != "cpp_value") {
      std::fprintf(stderr, "kv round-trip failed\n");
      return 1;
    }
    std::printf("kv OK\n");

    // Cross-language task: Python `add(a, b)`.
    ray_tpu_torch::Value sum = client.call(
        "cpp_add", {ray_tpu_torch::Client::make_int(2),
                    ray_tpu_torch::Client::make_int(40)});
    if (sum.i != 42) {
      std::fprintf(stderr, "add returned %lld\n",
                   static_cast<long long>(sum.i));
      return 1;
    }
    std::printf("call add OK: %lld\n", static_cast<long long>(sum.i));

    // Strings + structured result.
    ray_tpu_torch::Value info = client.call(
        "cpp_describe", {ray_tpu_torch::Client::make_str("tpu")});
    const ray_tpu_torch::Value* upper = info.get("upper");
    const ray_tpu_torch::Value* len = info.get("len");
    if (!upper || upper->s != "TPU" || !len || len->i != 3) {
      std::fprintf(stderr, "describe result wrong\n");
      return 1;
    }
    std::printf("call describe OK\n");

    // Remote error propagation.
    bool raised = false;
    try {
      client.call("cpp_fails", {});
    } catch (const std::runtime_error& e) {
      raised = std::string(e.what()).find("remote error") == 0;
    }
    if (!raised) {
      std::fprintf(stderr, "remote error not propagated\n");
      return 1;
    }
    std::printf("error propagation OK\n");

    // Actor API: create a Python actor, call methods over its direct
    // channel, observe state, propagate errors.
    ray_tpu_torch::Actor counter = client.create_actor(
        "cpp_counter_cls", {ray_tpu_torch::Client::make_int(100)});
    ray_tpu_torch::Value v1 = counter.call(
        "add", {ray_tpu_torch::Client::make_int(5)});
    ray_tpu_torch::Value v2 = counter.call(
        "add", {ray_tpu_torch::Client::make_int(7)});
    if (v1.i != 105 || v2.i != 112) {
      std::fprintf(stderr, "actor calls wrong: %lld %lld\n",
                   static_cast<long long>(v1.i),
                   static_cast<long long>(v2.i));
      return 1;
    }
    bool araised = false;
    try {
      counter.call("explode", {});
    } catch (const std::runtime_error& e) {
      araised = std::string(e.what()).find("remote error") == 0;
    }
    if (!araised) {
      std::fprintf(stderr, "actor error not propagated\n");
      return 1;
    }
    client.kill_actor(counter);
    std::printf("actor API OK\n");
    std::printf("CPP-CLIENT-OK\n");
    return 0;
  } catch (const std::exception& e) {
    std::fprintf(stderr, "FAILED: %s\n", e.what());
    return 1;
  }
}
