"""Read-stripe data-parallel alignment (the port of
``bsmap_tpu.parallel.sharded``, ``--engine sharded``).

Every mesh device aligns its own stripe of a window's reads against a
replicated genome and index with the single-device program
(``kernels.align_program``); the rows are bit-exact per read, because
reads are independent and the per-read selection hash is stateless.  The
stripes' rows meet on the mesh's first device, and the sum of their found
bits is the JAX program's ``psum`` of the aligned-read count.

Under ``obs`` each stripe is an ``engine.stripe`` span (its card and rows)
around its ``engine.h2d``, ``engine.launch`` and ``engine.gather`` (the
enqueue of its rows' copy to the first device); a stripe of padding alone,
not launched, is a ``mesh.skip`` instant.
"""

from __future__ import annotations

import torch

from .. import obs
from ..engine import device_engine as de
from ..engine import kernels
from ..engine.kernels import X_FOUND
from .mesh import make_mesh


class ShardedDeviceEngine(de.DeviceEngine):
    """DeviceEngine over a mesh: a window of ``ndev * B_loc`` reads is cut
    device-major into stripes of ``B_loc`` rows.  Candidate capacity is
    PER STRIPE, so each stripe's ok/overflow bits are those of the JAX
    program's stripe and the base class's retry works unchanged.  The
    probe pass is off (``_probe_ok``), as in ``bsmap_tpu``."""

    def __init__(self, genome, index, param, mesh=None,
                 b_loc: int | None = None):
        self.mesh = list(mesh) if mesh is not None else make_mesh()
        self.ndev = len(self.mesh)
        super().__init__(genome, index, param, device=self.mesh[0])
        self.B_loc = b_loc if b_loc is not None else de.DEV_BATCH
        self.B = self.ndev * self.B_loc      # the window the base class sees
        self._set_tiers(self.B_loc)          # capacity is PER STRIPE
        self.C_loc = self.CANDS
        self.last_n_aligned = 0
        self._probe_ok = False

    def _place_tables(self) -> dict:
        """One copy of the tables per distinct mesh device: stripes that
        share a card share its copy."""
        tabs = de.tables_from_numpy(self.genome, self.index, self.param)
        self.dev_tables = {dev: {k: v.to(dev) for k, v in tabs.items()}
                           for dev in dict.fromkeys(self.mesh)}
        return self.dev_tables[self.mesh[0]]

    def _dispatch(self, cfg, packed, cands: int | None = None):
        """Stripe d = rows [d*B_loc, (d+1)*B_loc) of the (m <= B) window,
        aligned on mesh device d; a stripe of padding alone (past the live
        rows) is not launched.  Returns the rows on the first device and
        keeps the found count as ``last_n_aligned`` (a device tensor)."""
        cap = self.C_loc if cands is None else cands
        if len(packed) > self.B:
            raise ValueError(f"{len(packed)} rows for a window of {self.B}")
        outs = []
        for d, dev in enumerate(self.mesh):
            lo = d * self.B_loc
            if d and lo >= len(packed):
                if obs.enabled():
                    for k in range(d, self.ndev):
                        obs.instant("mesh.skip", card=k)
                break
            stripe = packed[lo: lo + self.B_loc]
            with obs.span("engine.stripe", rows=len(stripe), card=d,
                          cpu=False):
                with obs.span("engine.h2d", nbytes=stripe.nbytes,
                              cpu=False):
                    rows = torch.from_numpy(stripe).to(dev)
                with obs.span("engine.launch", rows=len(stripe), cpu=False):
                    res = kernels.align_program(cfg, cap,
                                                self.dev_tables[dev], rows)
                with obs.span("engine.gather", cpu=False):
                    outs.append(res.to(self.mesh[0]))
        out = torch.cat(outs) if len(outs) > 1 else outs[0]
        if not cfg.probe:
            found = (out[:, 1] & 1) if cfg.lean \
                else out[:, 2 * cfg.maxseg + X_FOUND]
            self.last_n_aligned = found.sum()
        return out
