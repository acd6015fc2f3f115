"""SellFormat — SELL-C-σ adjacency (SlimSell) for the slab kernels.

A port of ``repro.formats.sell``.  The layout is the reference's,
bitwise:

* each vertex's adjacency is split into **virtual rows** of at most
  ``max_width`` neighbours (row splitting bounds a slice's width by the
  chunk size instead of the hub degree);
* virtual rows are sorted by length, descending and stable, inside
  windows of **σ** rows;
* the sorted rows form **slices** of C=128; each slice stores its
  adjacency column-major, padded to its own width rounded up to
  W_QUANT=8 columns, so the unit of storage is a **slab**, an (8, 128)
  int32 block.  ``cols[slab, q, lane]`` is a neighbour id (sentinel V
  pads), ``slab_rows[slab, lane]`` the owning vertex.

The build runs in torch on the graph's device: one stable sort keyed by
(window, -length) replaces the reference's per-window ``argsort`` loop,
and every edge lands in its (slab, column, lane) slot by one indexed
write.  Auto σ is the affinity table's row for the graph's geometry
class (`formats.affinity`), else `DEFAULT_SIGMA`.

Steps (``make_steps``):

* ``fused_gather``: the union planner's SELL arm (`kernels.plan`: a
  group is listed for a root iff one of its lanes owns a member of the
  frontier, or of ``~visited`` bottom-up; charged no launch, as the
  reference plans in jnp), K8 over that union (its ``cp.async`` ring at
  ``prefetch_depth > 0``) and K1 — two launches per layer;
* ``materialized``: K8 over every slab group (`sell_expand.dense_plan`)
  and K1;
* ``megakernel``: K9, one launch per layer;
* ``persistent``: K10, one launch per traversal (``persistent_run``);
* the semiring portfolio's step: the union planner (`kernels.plan`)
  and K12 over its union of slab groups.

Every mode maps onto the slab sweep (SIMD top-down; bottom-up swaps
the gate and the discovered side), except the scalar layers of
``algorithm="nonsimd"``, whose exact Algorithm-2 updates run the plain
dense sweep over `engine.expand_candidates`.
"""
from __future__ import annotations

import torch

from repro_torch.core.csr import Csr, round_up
from repro_torch.errors import GraphValidationError
from repro_torch.obs.metrics import record_degrade
from repro_torch.formats.base import Footprint, GraphFormat, nbytes
from repro_torch.formats.registry import register
from repro_torch.kernels import ops
from repro_torch.kernels import sell_expand as se
from repro_torch.kernels.sell_expand import SLICE_C, W_QUANT

#: the port's tile (slabs per work-list group): one thread per lane and
#: 256 threads per CTA cover two slabs
DEFAULT_SPP = 2


@register
class SellFormat(GraphFormat):
    name = "sell"
    # K9 plans, sweeps and restores a layer in one launch
    supports_megakernel = True
    # K10 runs the SIMD algorithm only: "nonsimd" scalar layers need the
    # plain dense sweep, which the in-kernel layer loop does not have
    supports_persistent = True
    persistent_algorithms = ("simd",)
    # K12 relaxes the slab groups the frontier plans
    supported_semirings = ("sssp", "cc", "ksource_bfs")

    DEFAULT_SIGMA = 8 * SLICE_C   # SlimSell's typical local-sort window

    def __init__(self, cols: torch.Tensor, slab_rows: torch.Tensor,
                 deg: torch.Tensor, n_vertices: int, n_edges: int,
                 sigma: int, nnz_stored: int):
        self.cols = cols            # (n_slabs, W_QUANT, C) int32
        self.slab_rows = slab_rows  # (n_slabs, C) int32
        self.deg = deg              # (V,) int32
        self._n_vertices = int(n_vertices)
        self._n_edges = int(n_edges)
        self.sigma = int(sigma)
        self.nnz_stored = int(nnz_stored)   # un-quantized padded slots
        self._deg_mat = None
        self._graphs: dict = {}
        self._structure_ok = False

    # -- construction ----------------------------------------------------
    @classmethod
    def from_csr(cls, csr: Csr, *, sigma: int | None = None,
                 max_width: int = 64) -> "SellFormat":
        """Row-split, σ-sort, slice, quantize and pack, on the CSR's
        device; the result equals the reference's ``from_csr`` array for
        array."""
        c, wq = SLICE_C, W_QUANT
        if max_width <= 0 or max_width % wq:
            raise ValueError(f"max_width must be a positive multiple of "
                             f"{wq}, got {max_width}")
        dev = csr.device
        i64 = dict(dtype=torch.int64, device=dev)
        v, n_edges = csr.n_vertices, csr.n_edges
        cs = csr.colstarts.to(torch.int64)
        deg = cs[1:] - cs[:-1]

        # virtual row table: owning vertex and chunk length per row
        n_full = deg // max_width
        tail = deg % max_width
        rows_per_vertex = n_full + (tail > 0).to(torch.int64)
        row_start = torch.cat([torch.zeros((1,), **i64),
                               torch.cumsum(rows_per_vertex, 0)])
        n_vrows = int(row_start[-1])
        n_rows = round_up(max(n_vrows, 1), c)
        vrow_vertex = torch.full((n_rows,), v, **i64)     # sentinel pad
        vrow_len = torch.zeros((n_rows,), **i64)
        if n_vrows:
            owner = torch.repeat_interleave(
                torch.arange(v, **i64), rows_per_vertex,
                output_size=n_vrows)
            chunk = torch.arange(n_vrows, **i64) - row_start[owner]
            vrow_vertex[:n_vrows] = owner
            vrow_len[:n_vrows] = torch.where(chunk < n_full[owner],
                                             max_width, tail[owner])
            del owner, chunk

        if sigma is None:
            # auto σ reads the affinity table like any other tuned knob
            # (affinity.sell.<geom>.sigma<N> rows)
            from repro_torch.formats import affinity
            sig = int(affinity.resolve(csr, "sigma", cls.DEFAULT_SIGMA,
                                       fmt_name="sell"))
        else:
            sig = int(sigma)
        sig = min(round_up(max(sig, c), c), n_rows)

        # σ-windowed descending length sort as ONE stable sort keyed by
        # (window, -length): lengths lie in [0, max_width]
        key = (torch.arange(n_rows, **i64) // sig) * (max_width + 1) \
            + (max_width - vrow_len)
        order = torch.sort(key, stable=True).indices
        del key

        n_slices = n_rows // c
        widths = vrow_len[order].reshape(n_slices, c).amax(dim=1)
        slab_counts = (widths + wq - 1) // wq               # quantized
        slab_base = torch.cat([torch.zeros((1,), **i64),
                               torch.cumsum(slab_counts, 0)])
        n_slabs = int(slab_base[-1])
        nnz_stored = int((widths * c).sum())
        sorted_vertex = vrow_vertex[order]
        rows_sorted = torch.where(sorted_vertex < v, sorted_vertex, v) \
            .to(torch.int32)
        del sorted_vertex, vrow_vertex, vrow_len

        if n_slabs == 0:       # edgeless graph: one all-sentinel slab
            cols = torch.full((1, wq, c), v, dtype=torch.int32, device=dev)
            slab_rows = torch.full((1, c), v, dtype=torch.int32,
                                   device=dev)
        else:
            cols = torch.full((n_slabs, wq, c), v, dtype=torch.int32,
                              device=dev)
            slab_rows = torch.repeat_interleave(
                rows_sorted.reshape(n_slices, c), slab_counts, dim=0,
                output_size=n_slabs)
            if n_edges:
                # every edge to its (slab, column, lane) slot, one write
                inv = torch.empty((n_rows,), **i64)
                inv[order] = torch.arange(n_rows, **i64)
                src = torch.repeat_interleave(torch.arange(v, **i64), deg,
                                              output_size=n_edges)
                j = torch.arange(n_edges, **i64) - cs[src]   # nth nbr
                pos = inv[row_start[src] + j // max_width]
                del src, inv
                j %= max_width                               # col in chunk
                slot = (slab_base[pos // c] + j // wq) * (wq * c) \
                    + (j % wq) * c + pos % c
                del pos, j
                cols.view(-1)[slot] = csr.rows[:n_edges]
                del slot
        return cls(cols, slab_rows, deg.to(torch.int32), v, n_edges, sig,
                   nnz_stored)

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return (self.cols, self.slab_rows, self.deg)

    def to(self, device) -> "SellFormat":
        if self.cols.device == torch.device(device):
            return self
        return SellFormat(self.cols.to(device), self.slab_rows.to(device),
                          self.deg.to(device), self._n_vertices,
                          self._n_edges, self.sigma, self.nnz_stored)

    def validate_structure(self) -> "SellFormat":
        """Geometry, shapes and id ranges (every id in [0, V]); memoized
        per instance: the checks read every slot once."""
        if self._structure_ok:
            return self
        super().validate_structure()
        v = self._n_vertices
        n_slabs = int(self.cols.shape[0])
        if tuple(self.cols.shape) != (n_slabs, W_QUANT, SLICE_C) \
                or tuple(self.slab_rows.shape) != (n_slabs, SLICE_C) \
                or tuple(self.deg.shape) != (v,):
            raise GraphValidationError(
                f"SELL arrays have shapes cols {tuple(self.cols.shape)}, "
                f"slab_rows {tuple(self.slab_rows.shape)}, deg "
                f"{tuple(self.deg.shape)}; expected (n_slabs, {W_QUANT}, "
                f"{SLICE_C}), (n_slabs, {SLICE_C}) and ({v},) — build "
                f"with SellFormat.from_csr")
        for name, t in (("cols", self.cols), ("slab_rows", self.slab_rows)):
            if t.dtype != torch.int32 or (t.numel() and (
                    int(t.min()) < 0 or int(t.max()) > v)):
                raise GraphValidationError(
                    f"SELL {name} must be int32 ids in [0, V={v}] (V is "
                    f"the sentinel); rebuild with SellFormat.from_csr")
        self._structure_ok = True
        return self

    # -- static geometry -------------------------------------------------
    @property
    def n_vertices(self) -> int:
        return self._n_vertices

    @property
    def n_edges(self) -> int:
        return self._n_edges

    @property
    def n_slabs(self) -> int:
        return int(self.cols.shape[0])

    @property
    def fill_ratio(self) -> float:
        """Real edges / stored (quantized) slots — the σ payoff."""
        return self._n_edges / max(self.edge_slots, 1)

    # -- engine contract -------------------------------------------------
    def degrees(self) -> torch.Tensor:
        return self.deg

    def resolve_tile(self, tile: int | None) -> int:
        """Slabs per work-list group: ``tile`` (at least 1) or, for auto,
        `DEFAULT_SPP` — one thread per lane fills a 256-thread CTA —
        never past the slab count."""
        if tile is None:
            return max(1, min(DEFAULT_SPP, self.n_slabs))
        return max(1, int(tile))

    def sell_graph(self, tile: int) -> se.SellGraph:
        """The kernels' loop constants at ``tile`` slabs per group: the
        slab arrays padded to the group once (built once per tile)."""
        if tile not in self._graphs:
            self._graphs[tile] = se.sell_graph(
                self.cols, self.slab_rows, self.deg, self._n_vertices,
                tile, self.n_vertices_padded)
        return self._graphs[tile]

    def _plan_slab_steps(self, active_words, slabs_per_step: int):
        """Active slab-group work-lists for (B, W) membership bitmaps
        (the frontier top-down, ``~visited`` bottom-up): ((B, n_steps)
        int32, (B,) counts)."""
        return se.plan_slabs_plain(self.sell_graph(slabs_per_step),
                                   active_words)

    def check_prefetch(self, tile: int, prefetch_depth: int) -> None:
        """Refuse a prefetch ring that no CTA can hold."""
        n_steps = self.sell_graph(tile).n_steps
        if not ops.sell_stage_fits(tile, prefetch_depth, n_steps):
            depth = min(prefetch_depth, n_steps)
            raise ValueError(
                f"prefetch_depth={prefetch_depth} at {tile} slabs per step "
                f"needs {se.stage_bytes(tile, depth)} bytes of shared "
                f"memory per CTA for its slab ring; the card allows "
                f"{ops.SMEM_OPTIN_BYTES}: use a smaller depth or tile")

    def _sweep_plain(self, frontier, visited, parent, algorithm: str):
        """The dense sweep over every slab of a root batch (the
        ``nonsimd`` scalar layer): the flattened slab stream with the
        row-in-frontier lane mask, into `engine.expand_candidates`."""
        from repro_torch.core import bitmap as bm
        from repro_torch.core.engine import expand_candidates
        n_batch = frontier.shape[0]
        nbr = self.cols.reshape(1, -1).expand(n_batch, -1)
        src = self.slab_rows[:, None, :].expand(-1, W_QUANT, -1) \
            .reshape(1, -1).expand(n_batch, -1)
        in_front = bm.test_bits(frontier, src) & (src < self._n_vertices)
        valid = in_front & (nbr < self._n_vertices)
        return expand_candidates(src, nbr, valid, frontier, visited,
                                 parent, self._n_vertices, algorithm)

    def _build_steps(self, spec) -> dict:
        from repro_torch.core import engine
        tile, depth = spec.tile, spec.prefetch_depth
        g = self.sell_graph(tile)
        n_steps = g.n_steps
        self.check_prefetch(tile, depth)
        # the persistent pipeline's per-layer steps (built only where
        # its kernel degrades) are the megakernel's
        mega = spec.pipeline in ("megakernel", "persistent")
        if mega and not ops.sell_megakernel_fits(tile, depth, n_steps):
            record_degrade(
                "smem_fallback",
                reason=(f"sell_megakernel(slabs={self.n_slabs}, spp={tile},"
                        f" depth={depth}) needs "
                        f"{ops.sell_megakernel_budget(tile, depth, n_steps)}"
                        f" bytes of shared memory per CTA, over "
                        f"{ops.SMEM_OPTIN_BYTES}"),
                fallback="pipeline='fused_gather' unfused slab steps (2 "
                         "launches/layer instead of 1)")
            mega = False

        # the materialized arm sweeps every slab group (K8 on the dense
        # plan), the SpMV sweep the reference's ablation streams
        planned = spec.pipeline != "materialized"

        def make_kernel_step(bottom_up: bool):
            def step(frontier, visited, parent):
                with ops.count_launches() as c:
                    plan = None
                    tiles = frontier.shape[0] * n_steps
                    if planned:
                        plan = (ops.plan_union(g, visited, complement=True)
                                if bottom_up else ops.plan_union(g, frontier))
                        tiles = plan.na.sum()
                    out_racy, p_racy = ops.sell_batched(
                        g, frontier, visited, torch.zeros_like(frontier),
                        parent, plan=plan, bottom_up=bottom_up,
                        prefetch_depth=depth)
                    p_fixed, delta = ops.restore(
                        p_racy, n_vertices=self._n_vertices)
                aux = engine.StepAux(tiles, 0, c.count)
                return out_racy | delta, visited | delta, p_fixed, aux
            return step

        def make_mega_step(bottom_up: bool):
            def step(frontier, visited, parent):
                with ops.count_launches() as c:
                    out, parent, na = ops.sell_layer_fused_batched(
                        g, frontier, visited, parent, bottom_up=bottom_up,
                        prefetch_depth=depth)
                aux = engine.StepAux(na.sum(), 0, c.count)
                return out, visited | out, parent, aux
            return step

        def dense_step(frontier, visited, parent):
            out, vis, par = self._sweep_plain(frontier, visited, parent,
                                              spec.algorithm)
            return out, vis, par, engine.StepAux(
                frontier.shape[0] * n_steps, 0, 0)

        make_step = make_mega_step if mega else make_kernel_step
        kernel_step = make_step(bottom_up=False)
        return {engine.MODE_SCALAR: (kernel_step if spec.algorithm == "simd"
                                     else dense_step),
                engine.MODE_SIMD: kernel_step,
                engine.MODE_BOTTOMUP: make_step(bottom_up=True)}

    def _build_semiring_step(self, spec, semiring):
        """The union planner lists the frontier's slab groups, K12 relaxes
        them; a ``dense`` root lists every group (the CC endgame)."""
        from repro_torch.core import engine
        g = self.sell_graph(spec.tile)

        def step(frontier, vals, dense):
            with ops.count_launches() as c:
                plan = ops.plan_union(g, frontier, dense=dense)
                new_vals, p_layer = ops.sell_relax_batched(
                    g, plan, frontier, vals, unit=semiring.unit,
                    weighted=semiring.weighted)
            return new_vals, p_layer, engine.StepAux(plan.na.sum(), 0,
                                                     c.count)

        return step

    # -- persistent (whole-traversal) contract ---------------------------
    def persistent_graph(self, spec) -> se.SellGraph:
        self.check_prefetch(spec.tile, spec.prefetch_depth)
        return self.sell_graph(spec.tile)

    def persistent_budget(self, spec) -> int:
        return ops.sell_megakernel_budget(
            spec.tile, spec.prefetch_depth,
            self.sell_graph(spec.tile).n_steps)

    def persistent_fits(self, n_roots: int, spec) -> bool:
        return ops.sell_persistent_fits(spec.tile, spec.prefetch_depth,
                                        self.sell_graph(spec.tile).n_steps)

    def persistent_run(self, frontier, visited, parent, spec):
        from repro_torch.core import engine
        code = engine.encode_policy(spec.policy, self._n_vertices,
                                    int(frontier.shape[0]),
                                    spec.max_layers)
        return ops.sell_traversal_fused_batched(
            self.sell_graph(spec.tile), frontier, visited, parent,
            code=code, max_layers=spec.max_layers,
            prefetch_depth=spec.prefetch_depth)

    # -- accounting ------------------------------------------------------
    def footprint(self) -> Footprint:
        return Footprint(self.name,
                         (("cols", nbytes(self.cols)),
                          ("slab_rows", nbytes(self.slab_rows)),
                          ("degrees", nbytes(self.deg))))

    @property
    def edge_slots(self) -> int:
        return self.n_slabs * W_QUANT * SLICE_C

    def layer_bytes(self) -> int:
        # one full sweep streams every cols slab and its slab_rows ids
        return 4 * self.n_slabs * (W_QUANT + 1) * SLICE_C

    def tile_bytes(self, tile: int) -> int:
        # one active slab group: ``tile`` slabs of cols + slab_rows
        return 4 * tile * (W_QUANT + 1) * SLICE_C

    def tile_count(self, tile: int) -> int:
        return -(-self.n_slabs // max(tile, 1))

    def plan_mask_bytes(self, packed: bool = True) -> int:
        # the slab planner is word-native whatever ``packed`` says
        return self.n_vertices_padded // 8

    def plan_bytes(self, tile: int, packed: bool = True) -> int:
        # every slab's row ids, the packed membership, the work-list
        return (4 * self.n_slabs * SLICE_C
                + self.plan_mask_bytes(packed) + 2 * 4 * self.tile_count(tile))
