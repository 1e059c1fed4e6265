"""Realistic-scale end-to-end run of the LWE public-LUT mod-p chain.

LWE public-LUT mod-p chain at n=2^13, L=8 x 28-bit limbs, base 2^14, d=1,
sigma_err=4.0 — the reference's test_lwe_modp_chain.rs workload at the
reference's own ring dimension class (their CPU test uses n=2^10 with 51-bit
towers; our u32 design compensates with depth). Offline pubkey pass, online
encoding pass, masked-rounding decode against the plaintext oracle; prints
per-phase wall times as one JSON line. The body is
`mxx_tpu.lookup.modp_chain.run_lwe_modp_chain`.

Run from the repo root: python scripts/realistic_scale_run.py
"""

import sys

sys.path.insert(0, ".")

import json
import tempfile

import mxx_tpu  # noqa: F401
import jax

from mxx_tpu.lookup.modp_chain import ERROR_SIGMA, run_lwe_modp_chain
from mxx_tpu.utils.compile_cache import enable_compile_cache

N = 1 << 13
L = 8
CRT_BITS = 28
BASE_BITS = 14


def main():
    enable_compile_cache()
    dev = jax.devices()[0]
    print(f"platform: {dev.platform} {dev.device_kind} x{len(jax.devices())}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        res = run_lwe_modp_chain((N, L, CRT_BITS, BASE_BITS), tmp)
    print(json.dumps({
        "workload": f"lwe_modp_chain n={N} L={L} crt_bits={CRT_BITS} "
                    f"base_bits={BASE_BITS} sigma={ERROR_SIGMA}",
        "device": dev.device_kind,
        "decode": "ok",
        "error_bits": res["error_bits"],
        "phases_s": res["phases_s"],
        "total_s": sum(res["phases_s"].values()),
    }), flush=True)


if __name__ == "__main__":
    main()
