"""The tail kernels: ingest (csrc/ingest.cu), the guided filter's
coefficients (gf_coeffs.cu) and the fused refine and composite
(refine_composite.cu), each once over a dispatch's frames, where the
configuration takes the guided tail at an integer pool."""

from portbench.yardstick import (geometry, gf_work, ingest_work,
                                 refine_composite_work)

KERNELS = ("ingest_kernel", "gf_kernel", "refine_composite_kernel")


def matches(name: str) -> bool:
    return any(k in name for k in KERNELS)


def work(config: dict, traffic: dict):
    geo = geometry(config, traffic)
    refine = config["pipeline"]["refine"]
    if not geo.pool or refine["mode"] != "guided":
        return []
    n = geo.frames
    return [ingest_work(n, geo.height, geo.width, geo.pool),
            gf_work(n, geo.net_h, geo.net_w, int(refine["guided_radius"])),
            refine_composite_work(n, geo.height, geo.width, geo.pool)]
