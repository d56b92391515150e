// C++ worker demo: object put/get + serving functions to Python callers.
//
// Usage: worker_demo <gcs_address> <socket_path>
//   1. puts an xlang object and gets it back (Client::put / Client::get)
//   2. registers C++ functions and serves `max_calls` Python calls
//      (ray_tpu_torch::Worker — the C++ task-execution loop).

#include <cstdio>
#include <string>

#include "ray_tpu_client.hpp"

using ray_tpu_torch::Client;
using ray_tpu_torch::Value;
using ray_tpu_torch::Worker;

static Value cpp_mul(const std::vector<Value>& args) {
  Value out;
  out.type = Value::INT;
  out.i = args.at(0).i * args.at(1).i;
  return out;
}

static Value cpp_concat(const std::vector<Value>& args) {
  Value out;
  out.type = Value::STR;
  out.s = args.at(0).s + ":" + args.at(1).s;
  return out;
}

static Value cpp_boom(const std::vector<Value>&) {
  throw std::runtime_error("intentional C++ failure");
}

int main(int argc, char** argv) {
  if (argc < 3) {
    std::fprintf(stderr, "usage: %s <gcs_address> <socket_path>\n", argv[0]);
    return 2;
  }
  std::string address = argv[1];
  std::string socket_path = argv[2];

  // --- objects: put an xlang value, read it back through the store.
  Client client(address);
  Value v;
  v.type = Value::MAP;
  v.map["answer"] = Client::make_int(42);
  v.map["who"] = Client::make_str("cpp");
  std::string oid = client.put(v);
  Value got = client.get(oid);
  if (!got.get("answer") || got.get("answer")->i != 42) {
    std::fprintf(stderr, "object round-trip failed\n");
    return 1;
  }
  // Publish the oid so the Python driver can ray_tpu_torch.get the same object
  // (C++ -> Python object hand-off).
  client.kv_put("cpp_put_oid", oid);
  std::printf("CPP-OBJECTS-OK\n");
  std::fflush(stdout);

  // --- execution: serve Python -> C++ calls until 4 calls arrived.
  Worker w(address, "demo_cpp_worker");
  w.register_function("mul", cpp_mul);
  w.register_function("concat", cpp_concat);
  w.register_function("boom", cpp_boom);
  w.serve(socket_path, /*max_calls=*/4);
  std::printf("CPP-WORKER-OK\n");
  return 0;
}
