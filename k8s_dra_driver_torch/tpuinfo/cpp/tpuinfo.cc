// libtpuinfo (the port's).  See tpuinfo.h for the ABI contract.  The fake
// mode is k8s_dra_driver_tpu/tpuinfo/cpp/tpuinfo.cc's, with the same
// results; the real mode enumerates NVIDIA cards.
//
// No iostreams: the shim runs inside processes that carry other C++
// runtimes (a PyTorch process), where an ostringstream's locale facets
// were found null (a crash in the first numeric insert, on an H100 host).
// Strings are built with std::string, std::to_string and stdio.

#include "tpuinfo.h"

#include <dirent.h>
#include <dlfcn.h>
#include <unistd.h>

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstdlib>
#include <cstdio>
#include <cstring>
#include <map>
#include <string>
#include <vector>

namespace {

constexpr const char* kVersion = "0.1.0";

struct Chip {
  int index = 0;
  std::string device_path;
  std::string uuid;
  std::array<int, 3> coords{0, 0, 0};
  int64_t hbm_bytes = 0;
  int cores = 1;
  bool healthy = true;
  std::string health_reason;  // empty when healthy
  std::string pci_address;
};

struct Topology {
  std::string mode;        // "fake" | "real"
  std::string generation;  // v5e, v4, v5p, v6e
  std::string topology;    // "4x4" or "2x2x2"
  std::array<int, 3> dims{1, 1, 1};
  int ndims = 2;
  std::array<bool, 3> wrap{false, false, false};
  std::array<int, 3> host_bounds{1, 1, 1};  // chips per host along each dim
  int chips_per_host = 0;
  int host_count = 1;
  int host_id = 0;
  std::vector<std::string> worker_hostnames;
  std::vector<Chip> chips;  // local host's chips only
  std::string driver_version = "accel-1.0";
  std::string libtpu_version = "unknown";
};

struct GenSpec {
  int ndims;
  int64_t hbm_bytes;
  int cores;
  // Chips per host along each dim when the slice spans multiple hosts.
  std::array<int, 3> host_bounds;
};

const std::map<std::string, GenSpec>& gen_specs() {
  static const std::map<std::string, GenSpec> specs = {
      // v5e/v6e: 2D ICI mesh, 16 GiB HBM, 1 TensorCore per chip, 2x2 hosts.
      {"v5e", {2, 16LL << 30, 1, {2, 2, 1}}},
      {"v6e", {2, 32LL << 30, 1, {2, 2, 1}}},
      // v4/v5p: 3D torus, 32/95 GiB HBM, 2 TensorCores per chip, 2x2x1 hosts.
      {"v4", {3, 32LL << 30, 2, {2, 2, 1}}},
      {"v5p", {3, 95LL << 30, 2, {2, 2, 1}}},
  };
  return specs;
}

// Smallest standard topology for `chips` chips of a generation.  2D shapes
// follow the v5e product matrix (1x1, 2x2, 2x4, 4x4, 4x8, 8x8, 8x16, 16x16);
// 3D shapes follow v4/v5p cubes-then-doubling.
bool shape_for(const std::string& gen, int chips, std::array<int, 3>* dims) {
  const auto& spec = gen_specs().at(gen);
  if (spec.ndims == 2) {
    static const std::array<std::array<int, 2>, 8> shapes = {{
        {1, 1}, {2, 2}, {2, 4}, {4, 4}, {4, 8}, {8, 8}, {8, 16}, {16, 16},
    }};
    for (const auto& s : shapes) {
      if (s[0] * s[1] == chips) {
        *dims = {s[0], s[1], 1};
        return true;
      }
    }
    return false;
  }
  static const std::array<std::array<int, 3>, 8> shapes = {{
      {1, 1, 1}, {2, 2, 1}, {2, 2, 2}, {2, 2, 4},
      {2, 4, 4}, {4, 4, 4}, {4, 4, 8}, {4, 8, 8},
  }};
  for (const auto& s : shapes) {
    if (s[0] * s[1] * s[2] == chips) {
      *dims = s;
      return true;
    }
  }
  return false;
}

std::string getenv_str(const char* name) {
  const char* v = std::getenv(name);
  return v ? std::string(v) : std::string();
}

// Tokens of `s` between `delim`s, as std::getline over a stream gives them:
// an empty input has none, and a trailing delimiter ends no extra token.
std::vector<std::string> split(const std::string& s, char delim) {
  std::vector<std::string> out;
  size_t start = 0;
  while (start < s.size()) {
    size_t pos = s.find(delim, start);
    if (pos == std::string::npos) {
      out.push_back(s.substr(start));
      break;
    }
    out.push_back(s.substr(start, pos - start));
    start = pos + 1;
  }
  return out;
}

std::string json_escape(const std::string& s) {
  std::string out;
  for (char c : s) {
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      default: out += c;
    }
  }
  return out;
}

// FNV-1a over identifying fields; gives stable, unique-enough device UUIDs.
std::string make_uuid(const std::string& gen, int host_id, int index) {
  std::string key = gen + ":" + std::to_string(host_id) + ":" + std::to_string(index);
  uint64_t h = 1469598103934665603ULL;
  for (char c : key) {
    h ^= static_cast<uint8_t>(c);
    h *= 1099511628211ULL;
  }
  char buf[64];
  std::snprintf(buf, sizeof(buf), "tpu-%s-%d-%d-%08llx", gen.c_str(), host_id, index,
                static_cast<unsigned long long>(h & 0xffffffffULL));
  return buf;
}

// Parse "v5e-16" -> (gen, chips).  Also accepts explicit topology "v4-2x2x2".
bool parse_fake_spec(const std::string& spec, std::string* gen, int* chips,
                     std::array<int, 3>* dims, bool* have_dims) {
  auto dash = spec.find('-');
  if (dash == std::string::npos) return false;
  *gen = spec.substr(0, dash);
  if (!gen_specs().count(*gen)) return false;
  std::string rest = spec.substr(dash + 1);
  if (rest.find('x') != std::string::npos) {
    std::array<int, 3> d{1, 1, 1};
    int i = 0;
    for (const std::string& part : split(rest, 'x')) {
      if (i >= 3 || part.empty()) return false;
      d[i++] = std::atoi(part.c_str());
    }
    *dims = d;
    *have_dims = true;
    *chips = d[0] * d[1] * d[2];
    return *chips > 0;
  }
  *chips = std::atoi(rest.c_str());
  *have_dims = false;
  return *chips > 0;
}

int finish_topology(Topology* t, bool force_single_host, std::string* err) {
  const auto& spec = gen_specs().at(t->generation);
  t->ndims = spec.ndims;
  int total = t->dims[0] * t->dims[1] * t->dims[2];

  // Single-host slices keep every chip local; multi-host slices partition the
  // mesh into host_bounds blocks (v5e: 2x2 chips/host; v4: 2x2x1).
  int single_host_max = (t->generation == "v5e" || t->generation == "v6e") ? 8 : 4;
  if (force_single_host || total <= single_host_max) {
    t->host_bounds = t->dims;
    t->chips_per_host = total;
    t->host_count = 1;
  } else {
    // A multi-host mesh must tile exactly into host blocks, or host
    // coordinate math is undefined (division by zero / truncation).
    for (int i = 0; i < 3; i++) {
      if (t->dims[i] % spec.host_bounds[i] != 0) {
        *err = "topology " + std::to_string(t->dims[0]) + "x" +
               std::to_string(t->dims[1]) + "x" + std::to_string(t->dims[2]) +
               " does not tile into " + t->generation + " host blocks";
        return 1;
      }
    }
    t->host_bounds = spec.host_bounds;
    t->chips_per_host = spec.host_bounds[0] * spec.host_bounds[1] * spec.host_bounds[2];
    t->host_count = total / t->chips_per_host;
  }

  // ICI wrap-around exists on 3D-torus generations when a dimension spans the
  // full pod axis; approximation: wrap any 3D dim >= 4 (documented heuristic).
  for (int i = 0; i < 3; i++) {
    t->wrap[i] = (spec.ndims == 3 && t->dims[i] >= 4);
  }

  std::string topo;
  for (int i = 0; i < t->ndims; i++) {
    if (i) topo += "x";
    topo += std::to_string(t->dims[i]);
  }
  t->topology = topo;
  return 0;
}

// Host blocks are laid out row-major over the mesh-of-hosts; chips within a
// host are row-major within the block.  Local chip coords are global.
void add_local_chips(Topology* t, const std::string& dev_prefix) {
  std::array<int, 3> hosts_per_dim;
  for (int i = 0; i < 3; i++) hosts_per_dim[i] = t->dims[i] / t->host_bounds[i];
  int hid = t->host_id;
  std::array<int, 3> host_coord;
  host_coord[2] = hid / (hosts_per_dim[0] * hosts_per_dim[1]);
  int rem = hid % (hosts_per_dim[0] * hosts_per_dim[1]);
  host_coord[1] = rem / hosts_per_dim[0];
  host_coord[0] = rem % hosts_per_dim[0];

  const auto& spec = gen_specs().at(t->generation);
  int index = 0;
  for (int z = 0; z < t->host_bounds[2]; z++) {
    for (int y = 0; y < t->host_bounds[1]; y++) {
      for (int x = 0; x < t->host_bounds[0]; x++) {
        Chip c;
        c.index = index;
        c.device_path = dev_prefix + std::to_string(index);
        c.coords = {host_coord[0] * t->host_bounds[0] + x,
                    host_coord[1] * t->host_bounds[1] + y,
                    host_coord[2] * t->host_bounds[2] + z};
        c.hbm_bytes = spec.hbm_bytes;
        c.cores = spec.cores;
        c.uuid = make_uuid(t->generation, hid, index);
        char pci[32];
        std::snprintf(pci, sizeof(pci), "0000:00:%02x.0", 4 + index);
        c.pci_address = pci;
        t->chips.push_back(c);
        index++;
      }
    }
  }
}

int enumerate_fake(Topology* t, std::string* err) {
  std::string spec = getenv_str("TPUINFO_FAKE_TOPOLOGY");
  std::string gen;
  int chips = 0;
  std::array<int, 3> dims{1, 1, 1};
  bool have_dims = false;
  if (!parse_fake_spec(spec, &gen, &chips, &dims, &have_dims)) {
    *err = "invalid TPUINFO_FAKE_TOPOLOGY: " + spec;
    return 1;
  }
  t->mode = "fake";
  t->generation = gen;
  if (!have_dims && !shape_for(gen, chips, &dims)) {
    *err = "no standard " + gen + " topology with " + std::to_string(chips) + " chips";
    return 1;
  }
  t->dims = dims;
  if (finish_topology(t, /*force_single_host=*/false, err)) return 1;

  std::string hid = getenv_str("TPUINFO_FAKE_HOST_ID");
  t->host_id = hid.empty() ? 0 : std::atoi(hid.c_str());
  if (t->host_id < 0 || t->host_id >= t->host_count) {
    *err = "TPUINFO_FAKE_HOST_ID out of range";
    return 1;
  }
  for (int i = 0; i < t->host_count; i++) {
    t->worker_hostnames.push_back("tpu-host-" + std::to_string(i));
  }
  t->libtpu_version = "fake-" + std::string(kVersion);
  add_local_chips(t, "/dev/accel");
  // Fault injection: TPUINFO_FAKE_DEAD_CHIPS="1,3" marks local chip
  // positions unhealthy (the hardware-free analog of a dead device node).
  std::string dead = getenv_str("TPUINFO_FAKE_DEAD_CHIPS");
  if (!dead.empty()) {
    for (const std::string& part : split(dead, ',')) {
      int pos = std::atoi(part.c_str());
      if (pos >= 0 && pos < static_cast<int>(t->chips.size())) {
        t->chips[pos].healthy = false;
        t->chips[pos].health_reason = "fault-injected";
      }
    }
  }
  return 0;
}

std::string read_file(const std::string& path) {
  std::string out;
  FILE* f = std::fopen(path.c_str(), "rb");
  if (f == nullptr) return out;
  char buf[4096];
  size_t n;
  while ((n = std::fread(buf, 1, sizeof(buf), f)) > 0) out.append(buf, n);
  std::fclose(f);
  return out;
}

std::string first_line(const std::string& s) {
  auto nl = s.find('\n');
  return nl == std::string::npos ? s : s.substr(0, nl);
}

// ---------------------------------------------------------------------------
// Real mode: the host's NVIDIA cards.
//
// The CUDA driver API is reached through dlopen("libcuda.so.1") with the few
// entry points declared here by hand, so the shim builds with g++ alone.
// Only cuInit and device queries are called: they create no context, so
// enumeration takes no card memory from any claim.
// ---------------------------------------------------------------------------

typedef int CUresult;
typedef int CUdevice;
struct CUuuid {
  unsigned char bytes[16];
};

constexpr int kAttrMultiprocessorCount = 16;  // CU_DEVICE_ATTRIBUTE_MULTIPROCESSOR_COUNT
constexpr int kAttrPciBusId = 33;             // CU_DEVICE_ATTRIBUTE_PCI_BUS_ID
constexpr int kAttrPciDeviceId = 34;          // CU_DEVICE_ATTRIBUTE_PCI_DEVICE_ID
constexpr int kAttrPciDomainId = 50;          // CU_DEVICE_ATTRIBUTE_PCI_DOMAIN_ID

struct CudaApi {
  CUresult (*init)(unsigned int) = nullptr;
  CUresult (*driver_version)(int*) = nullptr;
  CUresult (*device_count)(int*) = nullptr;
  CUresult (*device_get)(CUdevice*, int) = nullptr;
  CUresult (*device_name)(char*, int, CUdevice) = nullptr;
  CUresult (*total_mem)(size_t*, CUdevice) = nullptr;
  CUresult (*attribute)(int*, int, CUdevice) = nullptr;
  CUresult (*uuid)(CUuuid*, CUdevice) = nullptr;
  CUresult (*error_name)(CUresult, const char**) = nullptr;
};

std::string cuda_error(const CudaApi& api, const char* call, CUresult rc) {
  const char* name = nullptr;
  if (api.error_name == nullptr || api.error_name(rc, &name) != 0 || name == nullptr) {
    name = "unknown";
  }
  return std::string(call) + " failed: CUDA error " + std::to_string(rc) + " (" + name + ")";
}

// Loads libcuda.so.1 and runs cuInit once per process; later calls reuse it.
bool cuda_api(CudaApi* out, std::string* err) {
  static CudaApi api;
  static bool loaded = false;
  static std::string load_error;
  if (!loaded && load_error.empty()) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    if (h == nullptr) {
      const char* why = dlerror();
      load_error = std::string("libcuda.so.1 not loadable: ") + (why ? why : "unknown");
    } else {
      auto sym = [h](const char* name) { return dlsym(h, name); };
      api.init = reinterpret_cast<CUresult (*)(unsigned int)>(sym("cuInit"));
      api.driver_version = reinterpret_cast<CUresult (*)(int*)>(sym("cuDriverGetVersion"));
      api.device_count = reinterpret_cast<CUresult (*)(int*)>(sym("cuDeviceGetCount"));
      api.device_get = reinterpret_cast<CUresult (*)(CUdevice*, int)>(sym("cuDeviceGet"));
      api.device_name =
          reinterpret_cast<CUresult (*)(char*, int, CUdevice)>(sym("cuDeviceGetName"));
      api.total_mem =
          reinterpret_cast<CUresult (*)(size_t*, CUdevice)>(sym("cuDeviceTotalMem_v2"));
      api.attribute =
          reinterpret_cast<CUresult (*)(int*, int, CUdevice)>(sym("cuDeviceGetAttribute"));
      void* uuid = sym("cuDeviceGetUuid_v2");
      if (uuid == nullptr) uuid = sym("cuDeviceGetUuid");
      api.uuid = reinterpret_cast<CUresult (*)(CUuuid*, CUdevice)>(uuid);
      api.error_name =
          reinterpret_cast<CUresult (*)(CUresult, const char**)>(sym("cuGetErrorName"));
      if (!api.init || !api.driver_version || !api.device_count || !api.device_get ||
          !api.device_name || !api.total_mem || !api.attribute || !api.uuid) {
        load_error = "libcuda.so.1 lacks a driver API entry point this shim needs";
      } else {
        CUresult rc = api.init(0);
        if (rc != 0) {
          load_error = cuda_error(api, "cuInit", rc);
        } else {
          loaded = true;
        }
      }
    }
  }
  if (!loaded) {
    *err = load_error;
    return false;
  }
  *out = api;
  return true;
}

// "NVIDIA H100 80GB HBM3" -> "nvidia-h100-80gb-hbm3"
std::string slug(const std::string& name) {
  std::string out;
  for (char c : name) {
    if (isalnum(static_cast<unsigned char>(c))) {
      out += static_cast<char>(tolower(static_cast<unsigned char>(c)));
    } else if (!out.empty() && out.back() != '-') {
      out += '-';
    }
  }
  while (!out.empty() && out.back() == '-') out.pop_back();
  return out;
}

// nvidia-smi's form: GPU-xxxxxxxx-xxxx-xxxx-xxxx-xxxxxxxxxxxx
std::string format_uuid(const CUuuid& u) {
  std::string out = "GPU-";
  char hex[3];
  for (int i = 0; i < 16; i++) {
    if (i == 4 || i == 6 || i == 8 || i == 10) out += '-';
    std::snprintf(hex, sizeof(hex), "%02x", u.bytes[i]);
    out += hex;
  }
  return out;
}

// /dev/nvidia<N> minors present, sorted.
std::vector<int> device_node_minors() {
  std::vector<int> minors;
  if (DIR* d = opendir("/dev")) {
    while (dirent* e = readdir(d)) {
      std::string name = e->d_name;
      if (name.rfind("nvidia", 0) == 0 && name.size() > 6) {
        bool digits = true;
        for (size_t i = 6; i < name.size(); i++) {
          if (!isdigit(static_cast<unsigned char>(name[i]))) digits = false;
        }
        if (digits) minors.push_back(std::atoi(name.c_str() + 6));
      }
    }
    closedir(d);
  }
  std::sort(minors.begin(), minors.end());
  return minors;
}

// The card's minor from the driver's own record of it, -1 when unreadable.
int minor_from_proc(const std::string& pci) {
  std::string info = read_file("/proc/driver/nvidia/gpus/" + pci + "/information");
  auto pos = info.find("Device Minor:");
  if (pos == std::string::npos) return -1;
  return std::atoi(info.c_str() + pos + std::strlen("Device Minor:"));
}

// NVML (libnvidia-ml.so.1, dlopen'd like libcuda) names a card's minor
// where /proc/driver/nvidia is not mounted (a container); -1 when it cannot.
typedef void* NvmlDevice;

int minor_from_nvml(const std::string& pci) {
  static int (*by_pci)(const char*, NvmlDevice*) = nullptr;
  static int (*minor)(NvmlDevice, unsigned int*) = nullptr;
  static bool tried = false;
  if (!tried) {
    tried = true;
    if (void* h = dlopen("libnvidia-ml.so.1", RTLD_NOW | RTLD_LOCAL)) {
      auto init = reinterpret_cast<int (*)()>(dlsym(h, "nvmlInit_v2"));
      by_pci = reinterpret_cast<int (*)(const char*, NvmlDevice*)>(
          dlsym(h, "nvmlDeviceGetHandleByPciBusId_v2"));
      minor = reinterpret_cast<int (*)(NvmlDevice, unsigned int*)>(
          dlsym(h, "nvmlDeviceGetMinorNumber"));
      if (init == nullptr || init() != 0) by_pci = nullptr;
    }
  }
  if (by_pci == nullptr || minor == nullptr) return -1;
  NvmlDevice dev = nullptr;
  unsigned int m = 0;
  if (by_pci(pci.c_str(), &dev) != 0 || minor(dev, &m) != 0) return -1;
  return static_cast<int>(m);
}

struct Card {
  std::string pci;
  std::string name;
  std::string uuid;
  int64_t mem = 0;
  int sms = 0;
};

int enumerate_real(Topology* t, std::string* err) {
  CudaApi api;
  if (!cuda_api(&api, err)) return 1;
  int count = 0;
  CUresult rc = api.device_count(&count);
  if (rc != 0) {
    *err = cuda_error(api, "cuDeviceGetCount", rc);
    return 1;
  }
  if (count <= 0) {
    *err = "no NVIDIA card found";
    return 1;
  }
  std::vector<Card> cards;
  for (int ordinal = 0; ordinal < count; ordinal++) {
    CUdevice dev = 0;
    int domain = 0, bus = 0, slot = 0;
    char name[256] = {0};
    size_t mem = 0;
    CUuuid uuid{};
    Card c;
    if ((rc = api.device_get(&dev, ordinal)) != 0 ||
        (rc = api.device_name(name, sizeof(name) - 1, dev)) != 0 ||
        (rc = api.total_mem(&mem, dev)) != 0 ||
        (rc = api.attribute(&c.sms, kAttrMultiprocessorCount, dev)) != 0 ||
        (rc = api.attribute(&domain, kAttrPciDomainId, dev)) != 0 ||
        (rc = api.attribute(&bus, kAttrPciBusId, dev)) != 0 ||
        (rc = api.attribute(&slot, kAttrPciDeviceId, dev)) != 0 ||
        (rc = api.uuid(&uuid, dev)) != 0) {
      *err = cuda_error(api, "device query", rc) + " on card " + std::to_string(ordinal);
      return 1;
    }
    char pci[32];
    std::snprintf(pci, sizeof(pci), "%04x:%02x:%02x.0", domain, bus, slot);
    c.pci = pci;
    c.name = name;
    c.uuid = format_uuid(uuid);
    c.mem = static_cast<int64_t>(mem);
    cards.push_back(c);
  }
  // PCI bus order, whatever CUDA_DEVICE_ORDER says: the self-test child
  // (CUDA_DEVICE_ORDER=PCI_BUS_ID) must see the cards in this order.
  std::sort(cards.begin(), cards.end(),
            [](const Card& a, const Card& b) { return a.pci < b.pci; });

  // Each card's /dev/nvidia<minor>: the driver's record, else NVML's, else
  // the sorted device nodes matched in PCI order when their count is the
  // cards' (the driver numbers minors in PCI order).
  std::vector<int> minors(cards.size(), -1);
  bool all_known = true;
  for (size_t i = 0; i < cards.size(); i++) {
    minors[i] = minor_from_proc(cards[i].pci);
    if (minors[i] < 0) minors[i] = minor_from_nvml(cards[i].pci);
    if (minors[i] < 0) all_known = false;
  }
  if (!all_known) {
    std::vector<int> nodes = device_node_minors();
    if (nodes.size() != cards.size()) {
      *err = "found " + std::to_string(cards.size()) + " NVIDIA card(s) but " +
             std::to_string(nodes.size()) +
             " /dev/nvidia<N> node(s), and neither /proc/driver/nvidia nor NVML names "
             "their minors";
      return 1;
    }
    minors = nodes;
  }

  int n = static_cast<int>(cards.size());
  t->mode = "real";
  t->generation = slug(cards[0].name);
  t->dims = {n, 1, 1};
  t->ndims = 2;
  t->wrap = {false, false, false};
  t->host_bounds = t->dims;
  t->chips_per_host = n;
  t->host_count = 1;
  t->host_id = 0;
  t->topology = std::to_string(n) + "x1";
  int version = 0;
  if (api.driver_version(&version) == 0 && version > 0) {
    t->driver_version =
        "cuda-" + std::to_string(version / 1000) + "." + std::to_string((version % 1000) / 10);
  } else {
    t->driver_version = "cuda-unknown";
  }
  for (int i = 0; i < n; i++) {
    const Card& card = cards[i];
    Chip c;
    c.index = minors[i];
    c.device_path = "/dev/nvidia" + std::to_string(minors[i]);
    c.uuid = card.uuid;
    c.coords = {i, 0, 0};
    c.hbm_bytes = card.mem;
    c.cores = card.sms;
    c.pci_address = card.pci;
    // The reference's health sources at the card's PCI address, most
    // specific reason first (a card is marked unhealthy, never dropped):
    // 1. the PCI function's `enable` flag reads "0" when it is disabled
    //    (surprise-removed, firmware-fenced);
    std::string sys = "/sys/bus/pci/devices/" + card.pci + "/";
    std::string enable = first_line(read_file(sys + "enable"));
    if (!enable.empty() && enable == "0") {
      c.healthy = false;
      c.health_reason = "pci-disabled";
    }
    // 2. any recorded fatal PCIe (AER) error: the link cannot be trusted;
    if (c.healthy) {
      std::string aer = read_file(sys + "aer_dev_fatal");
      auto tpos = aer.find("TOTAL_ERR_FATAL");
      if (tpos != std::string::npos) {
        int total = std::atoi(aer.c_str() + tpos + std::strlen("TOTAL_ERR_FATAL"));
        if (total > 0) {
          c.healthy = false;
          c.health_reason = "aer-fatal";
        }
      }
    }
    // 3. a device node the runtime cannot open would hand pods a dead fd.
    if (c.healthy && access(c.device_path.c_str(), R_OK | W_OK) != 0) {
      c.healthy = false;
      c.health_reason = "node-unopenable";
    }
    t->chips.push_back(c);
  }
  return 0;
}

std::string json_bool(bool b) { return b ? "true" : "false"; }

std::string to_json(const Topology& t) {
  using std::to_string;
  std::string o = "{";
  o += "\"mode\":\"" + t.mode + "\",";
  o += "\"generation\":\"" + t.generation + "\",";
  o += "\"topology\":\"" + t.topology + "\",";
  o += "\"ndims\":" + to_string(t.ndims) + ",";
  o += "\"dims\":[" + to_string(t.dims[0]) + "," + to_string(t.dims[1]) + "," +
       to_string(t.dims[2]) + "],";
  o += "\"wrap\":[" + json_bool(t.wrap[0]) + "," + json_bool(t.wrap[1]) + "," +
       json_bool(t.wrap[2]) + "],";
  o += "\"host_bounds\":[" + to_string(t.host_bounds[0]) + "," + to_string(t.host_bounds[1]) +
       "," + to_string(t.host_bounds[2]) + "],";
  o += "\"chips_per_host\":" + to_string(t.chips_per_host) + ",";
  o += "\"host_count\":" + to_string(t.host_count) + ",";
  o += "\"host_id\":" + to_string(t.host_id) + ",";
  o += "\"worker_hostnames\":[";
  for (size_t i = 0; i < t.worker_hostnames.size(); i++) {
    if (i) o += ",";
    o += "\"" + json_escape(t.worker_hostnames[i]) + "\"";
  }
  o += "],";
  o += "\"driver_version\":\"" + json_escape(t.driver_version) + "\",";
  o += "\"libtpu_version\":\"" + json_escape(t.libtpu_version) + "\",";
  o += "\"chips\":[";
  for (size_t i = 0; i < t.chips.size(); i++) {
    const Chip& c = t.chips[i];
    if (i) o += ",";
    o += "{\"index\":" + to_string(c.index) + ",\"device_path\":\"" +
         json_escape(c.device_path) + "\",\"uuid\":\"" + c.uuid + "\",\"coords\":[" +
         to_string(c.coords[0]) + "," + to_string(c.coords[1]) + "," + to_string(c.coords[2]) +
         "],\"hbm_bytes\":" + to_string(c.hbm_bytes) + ",\"cores\":" + to_string(c.cores) +
         ",\"healthy\":" + json_bool(c.healthy) + ",\"health_reason\":\"" +
         json_escape(c.health_reason) + "\"" + ",\"pci_address\":\"" +
         json_escape(c.pci_address) + "\"}";
  }
  o += "]}";
  return o;
}

char* dup_string(const std::string& s) {
  char* out = static_cast<char*>(std::malloc(s.size() + 1));
  std::memcpy(out, s.c_str(), s.size() + 1);
  return out;
}

}  // namespace

extern "C" {

int tpuinfo_enumerate(char** json_out) {
  Topology t;
  std::string err;
  int rc;
  if (!getenv_str("TPUINFO_FAKE_TOPOLOGY").empty()) {
    rc = enumerate_fake(&t, &err);
  } else {
    rc = enumerate_real(&t, &err);
  }
  *json_out = dup_string(rc == 0 ? to_json(t) : err);
  return rc;
}

void tpuinfo_free(char* p) { std::free(p); }

const char* tpuinfo_version(void) { return kVersion; }

}  // extern "C"
