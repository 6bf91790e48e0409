#!/usr/bin/env python3
"""How far a meshed SignalService's results stray from the unmeshed
service's on the CPU, where the plain GEMMs round by the number of rows a
call computes.

Runs the graph of ``tests/test_torch_mesh_faults.py`` (STFT 256/128, a
pointwise mask, iSTFT, an 8-mel tap) at length 1024 on the CPU and
prints the largest absolute difference of each output:

  * a wave of 3 requests padded to 8 rows on a virtual 8-shard mesh,
    against the unmeshed service's 3-row call;
  * 4 sessions on a 4-slot mesh (one-row core calls), against 4 unmeshed
    sessions stacked into one 4-row call a tick;
  * the same 4 sessions against 4 unmeshed sessions each alone (one-row
    calls on both sides; 0 where the split and gather change nothing).

    PYTHONPATH=src python tools/mesh_cpu_rounding.py
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.launch.mesh import DataMesh
from repro_torch.serving import SignalRequest, SignalService
from repro_torch.signal import SignalGraph

T = 1024


def fig9() -> SignalGraph:
    g = SignalGraph("f")
    g.stft("spec", frame=256, hop=128)
    g.dnn("mask", "spec", fn=lambda p, z: torch.sigmoid(torch.abs(z) - 1.0))
    g.mul("enh", "spec", "mask")
    g.istft("out", "enh", hop=128)
    g.magnitude("mag", "enh", onesided=True)
    g.mel_filterbank("mel", "mag", sr=16_000, n_mels=8)
    g.outputs("out", "mel")
    return g


def service(mesh=None, batch_size=4) -> SignalService:
    svc = SignalService(batch_size=batch_size, mesh=mesh, device="cpu")
    svc.register("f", fig9())
    return svc


def drain(services, waves, chunk=512):
    sessions = [s.open_stream("f") for s in services]
    got = [{} for _ in sessions]
    for lo in range(0, len(waves[0]), chunk):
        for s, w in zip(sessions, waves):
            s.feed(w[lo:lo + chunk])
        for svc in dict.fromkeys(services):
            svc.stream_step()
        for g, s in zip(got, sessions):
            for k, v in s.read().items():
                g.setdefault(k, []).append(v)
    for g, s in zip(got, sessions):
        for k, v in s.close().items():
            g.setdefault(k, []).append(v)
    return [{k: np.concatenate(v, axis=-1 if k == "out" else 0)
             for k, v in g.items()} for g in got]


def worst(a, b) -> dict:
    return {k: float(max(np.abs(x[k] - y[k]).max() for x, y in zip(a, b)))
            for k in a[0]}


def main() -> None:
    rng = np.random.default_rng(0)
    sigs = [rng.standard_normal(n).astype(np.float32)
            for n in (1024, 900, 700)]
    reqs = [SignalRequest(rid=i, graph="f", samples=s)
            for i, s in enumerate(sigs)]
    meshed = service(8).serve(reqs)
    reqs = [SignalRequest(rid=i, graph="f", samples=s)
            for i, s in enumerate(sigs)]
    plain = service().serve(reqs)
    print(f"torch {torch.__version__}, CPU")
    print("wave of 3 padded to 8 rows (virtual 8-shard mesh) vs the "
          "unmeshed 3-row call: max abs diff",
          worst([meshed[i] for i in range(3)], [plain[i] for i in range(3)]))
    waves = [rng.standard_normal(3 * T).astype(np.float32)
             for _ in range(4)]
    on_slots = drain([service(DataMesh(["cpu"] * 4))] * 4, waves)
    stacked = drain([service()] * 4, waves)
    alone = drain([service() for _ in waves], waves)
    print("4 sessions on 4 slots (one-row core calls) vs 4 unmeshed "
          "sessions stacked (one 4-row call a tick): max abs diff",
          worst(on_slots, stacked))
    print("4 sessions on 4 slots vs 4 unmeshed sessions each alone: max "
          "abs diff", worst(on_slots, alone))


if __name__ == "__main__":
    main()
