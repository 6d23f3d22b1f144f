/* libtpuinfo (the port's) — C ABI for card/topology enumeration.
 *
 * The counterpart of k8s_dra_driver_tpu/tpuinfo/cpp/tpuinfo.h with its ABI
 * and JSON contract kept.  Two modes:
 *
 *   real — the host's NVIDIA cards through the CUDA driver API
 *          (libcuda.so.1, loaded with dlopen: no CUDA headers needed to
 *          build), each card's /dev/nvidia<minor> from /proc/driver/nvidia
 *          or NVML (libnvidia-ml.so.1, dlopen'd too), and the cards' PCI
 *          sysfs nodes.
 *          n cards form one n x 1 slice on one host; no CUDA context is
 *          ever created.
 *   fake — synthetic topology selected by TPUINFO_FAKE_TOPOLOGY (e.g.
 *          "v5e-16", "v4-16"), local host by TPUINFO_FAKE_HOST_ID: exactly
 *          the reference's fake mode (the CPU tests' topologies).
 *
 * The result crosses the ABI as a single JSON document: the enumeration logic
 * lives in C++; Python only parses.
 */

#ifndef TPUINFO_H_
#define TPUINFO_H_

/* Built with -fvisibility=hidden: these three are the only exported names,
 * so no template the shim instantiates can bind to another library's copy
 * in the host process. */
#define TPUINFO_API __attribute__((visibility("default")))

#ifdef __cplusplus
extern "C" {
#endif

/* Enumerate the local host's cards (or a fake topology's chips) and slice
 * topology.
 * On success returns 0 and sets *json_out to a malloc'd JSON string the
 * caller must release with tpuinfo_free().  On failure returns nonzero and
 * sets *json_out to a malloc'd error message (also to be freed). */
TPUINFO_API int tpuinfo_enumerate(char** json_out);

TPUINFO_API void tpuinfo_free(char* p);

TPUINFO_API const char* tpuinfo_version(void);

#ifdef __cplusplus
}
#endif

#endif /* TPUINFO_H_ */
