"""Warm-start pipeline: C -> features -> GNN -> seed policy -> exact solve.

Port of ``lapgnn_tpu/pipeline.py``.  Both modes share the dual prediction on
the GPU: for a OneGNN the row features through kernel K3, which runs K1; for
a DualGNN the dense graph features over every edge (the JAX
``evaluation.DualGNNPredictor``'s predict); then the seed policy, whose
min-trick projections go through K2:

  * ``device`` (the default, as in the JAX class): the seeded
    Jonker–Volgenant solve runs on the GPU in float32
    (``solver.seeded.lapjv_seeded_single``, whose greedy, ARR and
    augmentation loops are the persistent kernels S3, S2 and S1), instance
    by instance with no read by the host; one packed float32 buffer ``[cost,
    used_fallback, col_of_row, v]`` comes back to the host in one copy, the
    batch's only one, and ``certify=True``
    holds each result to the float64 certificate against the caller's
    matrix, repairing the duals or polishing on the host where it fails.
  * ``hybrid``: ``(u, v)`` come back in one stacked copy and the native
    seeded solver solves exactly in float64 on the host (the original
    system's own GPU posture: GPU predict, then a C++ solve).

Both modes take the cost through a transfer encoding (``transfer_dtype``):
float32, the 16-bit floats bfloat16 and float16, or (device mode only) the
uint16 fixed-point code of ``quantize_u16`` and the row-top-k code of
``quantize_topk16``.  A host array is packed on the host and uploaded;
``_decode_transfer`` turns the payload back into a float32 matrix on the
device.  ``solve_stream`` pipelines the pack, the upload (a pinned copy on a
CUDA stream of its own) and the certificate of a stream of instances around
the device solves.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from . import tracing
from .device import resolve_device
from .graphs import GraphedCall
from .models import DualGNN, OneGNN
from .ops.dual import fast_min_trick, robust_normalize
from .ops.features import fast_row_features, graph_features
from .ops.rank1 import rank1_duals
from .ops.sinkhorn import auto_select_seed
from .solver.jv import SolveStats
from .solver.seeded import lapjv_seeded_single
from .train.convert import params_from_flax

__all__ = ["WarmStartPipeline", "predict_duals_fn", "quantize_u16", "quantize_topk16"]

# Two-segment uint16 fixed-point code (pipeline.py:34-39 of the JAX version):
# codes 0.._U16_BULK-1 grid the bulk range [lo, cap] finely; codes
# _U16_BULK..65535 grid the tail (cap, hi] coarsely (sentinels, outliers).
_U16_BULK = 61440
_U16_TAIL = 65536 - _U16_BULK  # 4096

Payload = Union[torch.Tensor, Dict[str, torch.Tensor]]


def quantize_u16(a: np.ndarray) -> Dict[str, np.ndarray]:
    """Per-instance two-segment uint16 fixed-point encoding of a cost batch
    (a copy of the JAX version's, pipeline.py:42).

    Returns ``{"q": (B,n,m) uint16, "lo"/"step"/"cap"/"step2": (B,) f32}``;
    decode is ``lo + step*q`` for bulk codes (q < 61440) and
    ``cap + step2*(q - 61440)`` for tail codes.  Accepts (n, m) or
    (B, n, m); always returns batched.

    The bulk grid ends at a robust ``cap = min(hi, p25 + 16*(p25 - p10))``
    from the low quantiles of an 8x8-strided subsample, so forbidden-edge
    sentinels (the sparse family's 1e6 entries) take tail codes instead of
    stretching the bulk step; constant and all-tie matrices still get
    strictly positive steps.  NaN entries take code 65535.  Exactness is
    restored against the true f64 matrix by ``certify=True``.
    """
    a32 = np.ascontiguousarray(a, np.float32)
    if a32.ndim == 2:
        a32 = a32[None]
    B = a32.shape[0]
    flat = a32.reshape(B, -1)
    with np.errstate(invalid="ignore"):
        lo = np.nanmin(flat, axis=1)
        hi = np.nanmax(flat, axis=1)
    sub = a32[:, ::8, ::8].reshape(B, -1)
    p10, p25 = np.nanpercentile(sub, [10.0, 25.0], axis=1).astype(np.float32)
    cap = np.minimum(hi, p25 + 16.0 * np.maximum(p25 - p10, 0.0))
    cap = np.maximum(cap, np.nextafter(lo, np.float32(np.inf)))
    step = ((cap.astype(np.float64) - lo) / (_U16_BULK - 1)).astype(np.float32)
    step2 = np.maximum(
        ((hi.astype(np.float64) - cap) / (_U16_TAIL - 1)).astype(np.float32),
        np.float32(1e-37),
    )
    bulk = a32 <= cap[:, None, None]
    qf = np.where(
        bulk,
        np.rint((a32 - lo[:, None, None]) / step[:, None, None]),
        _U16_BULK + np.rint((a32 - cap[:, None, None]) / step2[:, None, None]),
    )
    q = np.clip(np.nan_to_num(qf, nan=65535.0), 0.0, 65535.0).astype(np.uint16)
    return {"q": q, "lo": lo, "step": step, "cap": cap, "step2": step2}


def quantize_topk16(a: np.ndarray, k: int = 64) -> Dict[str, np.ndarray]:
    """Top-k row-sparsified uint16 transfer encoding (a copy of the JAX
    version's, pipeline.py:104): only each row's k smallest entries travel.

    Returns ``{"qv": (B,n,k) uint16, "qi": (B,n,k) uint16 column indices,
    "lo"/"step"/"fill": (B,) f32}``; ``_decode_transfer`` rebuilds a dense
    matrix filled with ``fill``, strictly above every kept value, and
    scatters the decoded values back.  n*k*4 bytes instead of n*n*4, and a
    u16 grid over the kept range only.  Where the optimum uses an unkept
    edge (the noisy_linear family does, on every instance measured), the
    certificate fails and the host polish restores the exact optimum.

    NaN values take the top code.  Needs m <= 65535 (uint16 column
    indices); k is clamped to m.
    """
    a32 = np.ascontiguousarray(a, np.float32)
    if a32.ndim == 2:
        a32 = a32[None]
    B, n, m = a32.shape
    if m > 65535:
        raise ValueError("topk16 transfer needs n <= 65535 for u16 indices")
    k = min(k, m)
    idx = np.argpartition(a32, k - 1, axis=-1)[..., :k]
    vals = np.take_along_axis(a32, idx, axis=-1)
    flat = vals.reshape(B, -1)
    with np.errstate(invalid="ignore"):
        lo = np.nanmin(flat, axis=1)
        cap = np.nanmax(flat, axis=1)
    span = np.maximum(cap - lo, np.float32(1e-30))
    step = (span.astype(np.float64) / 65535).astype(np.float32)
    qf = np.rint((vals - lo[:, None, None]) / step[:, None, None])
    qv = np.clip(np.nan_to_num(qf, nan=65535.0), 0.0, 65535.0).astype(np.uint16)
    fill = cap + np.float32(0.25) * span + np.float32(1e-6)
    return {
        "qv": qv,
        "qi": idx.astype(np.uint16),
        "lo": lo,
        "step": step,
        "fill": fill,
    }


def _decode_transfer(cost: Payload) -> torch.Tensor:
    """A transfer payload on any device -> the (B, n, m) float32 matrix there
    (pipeline.py:178 of the JAX version, operation for operation, so that the
    decoded bits and with them the device solver's ties are the JAX ones).

    A dict with "qi" is the top-k code: a dense matrix of ``fill``, for
    n <= 8192 tie-broken by the per-column ramp ``fill + j*(fill*2.5e-7)``
    (constant above, where the ramp slowed the solve), with the kept values
    scattered into their columns (unique within a row).  A dict with "q" is
    the two-segment uint16 code.  A tensor is cast to float32.  The uint16
    tensors are converted before any arithmetic: torch supports little else
    on them."""
    if isinstance(cost, dict) and "qi" in cost:
        qv, qi = cost["qv"].to(torch.float32), cost["qi"].to(torch.int64)
        B, n, k = qv.shape
        vals = cost["lo"][:, None, None] + cost["step"][:, None, None] * qv
        fill = cost["fill"][:, None, None]
        if n <= 8192:
            ramp = torch.arange(n, dtype=torch.float32, device=qv.device)[None, None, :]
            fill = fill + ramp * (fill * 2.5e-7)
        return fill.expand(B, n, n).contiguous().scatter_(2, qi, vals)
    if isinstance(cost, dict):
        qf = cost["q"].to(torch.float32)
        bulk = cost["lo"][:, None, None] + cost["step"][:, None, None] * qf
        tail = cost["cap"][:, None, None] + cost["step2"][:, None, None] * (
            qf - float(_U16_BULK)
        )
        return torch.where(qf < float(_U16_BULK), bulk, tail)
    return cost.to(torch.float32)


def device_batch(cost, device: torch.device) -> torch.Tensor:
    """A host array or a tensor, (n, m) or (B, n, m) -> a contiguous
    (B, n, m) float32 batch on ``device`` (a tensor already there is cast
    there)."""
    if isinstance(cost, torch.Tensor):
        t = cost.to(device, torch.float32)
    else:
        t = torch.from_numpy(np.ascontiguousarray(cost, np.float32)).to(device)
    return (t if t.ndim == 3 else t[None]).contiguous()


def _map_payload(fn: Callable[[torch.Tensor], torch.Tensor], payload: Payload) -> Payload:
    if isinstance(payload, dict):
        return {key: fn(t) for key, t in payload.items()}
    return fn(payload)


def predict_duals_fn(
    model: Union[OneGNN, DualGNN],
    use_cost_refinement: bool = True,
    normalize_costs: bool = False,
    seed_mode: str = "auto",
) -> Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """Build ``predict(cost) -> (u, v)`` for a (B, n, n) float32 batch on
    the model's device.  The pair is always dual-feasible.

    As in the JAX version: ``normalize_costs`` feeds the model the
    sentinel-robust [0, 1] image of each instance and maps the duals back;
    ``seed_mode`` 'gnn' serves the model's seed, 'rank1' the closed-form
    rank-1 seed, and 'auto' selects among the model seed, the rank-1 seed and
    the Sinkhorn-refined winner (``ops.sinkhorn.auto_select_seed``).  The
    model's weights live in the module, so ``predict`` takes no parameters.

    A ``DualGNN`` reads the dense graph features of the raw costs
    (``ops.features.graph_features``, which scales them itself, so
    ``normalize_costs`` raises) and runs without dropout; its u goes through
    the same seed policy, and its v_hint is not served: the min-trick gives
    v, as the original system's evaluation does (``gnn/eval.py:119``).

    A OneGNN's predict of a CUDA float32 cost is served from CUDA graphs
    (``graphs.GraphedCall``, its counters ``predict_graph.replay`` /
    ``.capture`` / ``.eager``), captured on the second call of each
    (B, n, m) and replayed from the third, with the same spans and launch
    counts as the eager chain and bit-equal results; the first call of a
    shape, the CPU, other dtypes and ``seed_mode='rank1'`` run eagerly.  A
    DualGNN's predict runs eagerly too: its forward is device-bound (about
    40 ms at n = 2048 on an H100, against 1 ms of launches), and
    ``lapbench``'s DualGNN serving cell reads each call's u from the
    model's ``forward``, which a replay does not call.  ``predict.graphs``
    is the ``GraphedCall`` (a DualGNN's too, called directly).  The
    returned (u, v) are the caller's own."""
    if seed_mode not in ("gnn", "rank1", "auto"):
        raise ValueError("seed_mode must be 'gnn', 'rank1', or 'auto'")
    dual = isinstance(model, DualGNN)
    if dual and normalize_costs:
        raise ValueError("a DualGNN scales the raw costs itself: pass normalize_costs=False")

    def run(cost: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        dev = cost.device
        if seed_mode == "rank1":
            with tracing.span("predict.seed", dev):
                u, _ = rank1_duals(cost)
                return u, fast_min_trick(cost, u)
        with tracing.span("predict.features", dev):
            if dual:
                feats = graph_features(cost)
            else:
                if normalize_costs:
                    cost_in, mn, a = robust_normalize(cost)
                else:
                    cost_in = cost
                feats = fast_row_features(cost_in)
        with tracing.span("predict.model", dev):
            if dual:
                u = model(feats.edge_feat, feats.row_feat, feats.col_feat)["u"]
            else:
                u = model(feats, cost=cost_in if use_cost_refinement else None)["u"]
            u = u.to(cost.dtype)
            if normalize_costs:
                u = u * a[..., None] + mn[..., None]
        with tracing.span("predict.seed", dev):
            if seed_mode == "auto":
                return auto_select_seed(cost, u)
            return u, fast_min_trick(cost, u)

    graphed = GraphedCall(run, "predict_graph")
    replays = seed_mode != "rank1" and not dual

    @torch.inference_mode()
    @tracing.spanned("predict", lambda cost: cost.device)
    def predict(cost: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if replays and cost.device.type == "cuda" and cost.dtype == torch.float32:
            return graphed(cost)
        return graphed.eager(cost)

    predict.graphs = graphed
    return predict


class WarmStartPipeline:
    """Batched GNN-seeded LAP solving.

    Args follow the JAX class, plus ``device``: the GPU by default (raises
    without one); pass ``device="cpu"`` to run on the CPU.  ``model`` is a
    ``OneGNN`` or a ``DualGNN`` (``train.build_model_from_meta`` builds
    either from a checkpoint); a DualGNN needs ``normalize_costs=False``
    (``predict_duals_fn``).  ``params`` is the flax parameter tree that
    ``train.checkpoint.load_checkpoint`` returns; it is loaded into
    ``model``, which moves to ``device``.

    ``transfer_dtype`` is how a cost reaches the device: 'float32', the
    16-bit floats 'bfloat16' / 'float16', or, in device mode only, 'uint16'
    (``quantize_u16``) and 'topk16' (``quantize_topk16`` with
    ``transfer_topk`` entries a row).  The residency rule, as in the JAX
    class: a tensor already on the pipeline's device is only cast there (to
    float32 for 'uint16' / 'topk16', which would only lose bits, else to the
    transfer dtype); anything else is packed on the host (``_to_xfer``) and
    uploaded.  The device solves the decoded matrix; ``certify=True`` holds
    the result to the caller's true matrix in float64.
    """

    def __init__(
        self,
        model: Union[OneGNN, DualGNN],
        params,
        mode: str = "device",
        eps: float = 1e-12,
        use_cost_refinement: bool = True,
        gate: str = "both",
        normalize_costs: bool = True,
        certify_tol: float = 1e-6,
        seed_mode: str = "auto",
        transfer_dtype: str = "float32",
        transfer_topk: int = 64,
        route: str = "auto",
        route_device_min_n: int = 1200,
        route_native_max_n: int = 384,
        device: Optional[Union[str, torch.device]] = None,
    ):
        if mode not in ("device", "hybrid"):
            raise ValueError("mode must be 'device' or 'hybrid'")
        if transfer_dtype not in ("float32", "bfloat16", "float16", "uint16", "topk16"):
            raise ValueError(
                "transfer_dtype must be 'float32', 'bfloat16', 'float16', "
                "'uint16', or 'topk16'"
            )
        if transfer_dtype in ("uint16", "topk16") and mode != "device":
            raise ValueError(f"transfer_dtype={transfer_dtype!r} requires mode='device'")
        if route not in ("auto", "device", "host"):
            raise ValueError("route must be 'auto', 'device', or 'host'")
        if gate not in ("density", "free_rows", "both", "never"):
            raise ValueError("gate must be 'density', 'free_rows', 'both', or 'never'")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # a definite index, so that tensors on it compare equal to it
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.mode = mode
        self.eps = eps
        self.gate = gate
        self.certify_tol = certify_tol
        self.seed_mode = seed_mode
        self.transfer_dtype = transfer_dtype
        self.transfer_topk = transfer_topk
        # what a tensor already on the device is cast to (the residency rule)
        self._resident_dtype = {"bfloat16": torch.bfloat16, "float16": torch.float16}.get(
            transfer_dtype, torch.float32
        )
        self.route = route
        self.route_device_min_n = route_device_min_n
        self.route_native_max_n = route_native_max_n
        # Loop counts of each instance of the last device-mode solve.
        self.last_solve_stats: List[SolveStats] = []
        model.load_state_dict(params_from_flax(params))
        self.model = model.to(self.device).eval()
        self._predict = predict_duals_fn(
            self.model, use_cost_refinement, normalize_costs, seed_mode
        )

    def predict_duals(self, cost) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, n, n) -> ((B, n) u, (B, n) v) on the device, dual-feasible."""
        return self._predict(device_batch(cost, self.device))

    def _to_xfer(self, c) -> Payload:
        """Pack a host array into the transfer encoding, as CPU tensors; the
        payload is always batched (pipeline.py:495 of the JAX version).

        bfloat16 packs by integer bit operations on the float32 image
        (round to nearest even: add 0x7FFF plus the kept lowest bit, shift),
        the JAX version's own bits for every input: float64 rounds twice (to
        float32, then to bfloat16), and a NaN's payload carries into the
        exponent, so NaN packs to an infinity.  Either only seeds the solve;
        the certificate reads the true matrix."""
        if self.transfer_dtype in ("topk16", "uint16"):
            enc = (quantize_topk16(c, self.transfer_topk) if self.transfer_dtype == "topk16"
                   else quantize_u16(c))
            return {key: torch.from_numpy(a) for key, a in enc.items()}
        if self.transfer_dtype == "bfloat16":
            bits = np.ascontiguousarray(c, np.float32).view(np.uint32)
            hi = ((bits + np.uint32(0x7FFF) + ((bits >> np.uint32(16)) & np.uint32(1)))
                  >> np.uint32(16)).astype(np.uint16)
            out = torch.from_numpy(hi.view(np.int16)).view(torch.bfloat16)
        else:
            out = torch.from_numpy(np.ascontiguousarray(c, self.transfer_dtype))
        return out if out.ndim == 3 else out[None]

    @tracing.spanned("stage")
    def _stage(self, cost) -> Payload:
        """The residency rule: ``cost`` -> a batched payload on the device."""
        if isinstance(cost, torch.Tensor) and cost.device == self.device:
            t = cost.to(self._resident_dtype)
            return (t if t.ndim == 3 else t[None]).contiguous()
        host = self._to_xfer(_host_array(cost))
        return _map_payload(lambda t: tracing.to_device(t, self.device), host)

    @tracing.spanned("readback")
    def _read_back(self, packed: torch.Tensor) -> np.ndarray:
        """The one copy of a call's packed result to the host."""
        return tracing.to_host(packed).numpy()

    @tracing.spanned("solve", lambda self, *args, **kwargs: self.device)
    def solve(self, cost, certify: bool = False) -> Dict[str, np.ndarray]:
        """Solve a batch.  Returns a dict with col_of_row, cost and
        used_fallback; with ``certify`` also certified, gap_bound, repaired,
        polished and polish_ms.

        In device mode ``certify`` evaluates the float64 dual certificate of
        each float32 device result against ``cost`` on the host, repairs the
        duals or polishes the assignment where it fails (as in the JAX
        version); certified entries take the float64 cost of their
        assignment.  Hybrid solves are float64-exact, so their certificate
        fields are trivially satisfied.  The call is the tracer's root span
        ``lapgnn.solve``."""
        on_card = isinstance(cost, torch.Tensor) and cost.device.type == "cuda"
        shape = tuple(np.shape(cost))
        if not on_card and self._route_to_host(shape[-1]):
            return self._solve_host_route(_host_f64(cost), certify)
        if self.mode == "device" and shape[-2] != shape[-1]:
            raise ValueError(f"device mode solves square instances, got {shape}")
        payload = self._stage(cost)
        if self.mode == "device":
            packed = self._read_back(self._e2e(payload))
            out = self._unpack(packed, shape[-1])
            if certify:
                self._certify_and_polish(_host_f64(cost), packed, out)
            return out
        out = self._solve_hybrid(cost, payload)
        if certify:
            _add_trivial_certificate(out)
        return out

    def _route_to_host(self, n: int) -> bool:
        """Whether a batch of size n that lies on the host solves on the host.
        ``route="host"`` always; ``"auto"`` in device mode below
        ``route_device_min_n``, and only when the pipeline's device is a GPU
        (on the CPU the device is the host: there is no transfer to save).
        A CUDA tensor is never routed."""
        if self.route == "host":
            return True
        if self.route != "auto" or self.mode != "device":
            return False
        return n < self.route_device_min_n and self.device.type == "cuda"

    def solve_stream(self, costs, certify: bool = False, microbatch: int = 1) -> list:
        """Pipelined solve of a stream of host instances; one result dict per
        instance (leading dimension 1), the schema of ``solve``; device mode
        only, and never routed by size (pipeline.py:769 of the JAX version).

        Three stages run beside the device solves: one worker packs each
        instance (``_to_xfer``, then a copy into pinned memory), one ahead of
        the uploads; another uploads with ``non_blocking`` copies on a CUDA
        stream of its own and records an event after each, at most ``DEPTH``
        ahead of the solve; the solve's stream waits on that event before the
        decode.  With ``certify`` the float64 certificates run on a pool of
        two workers (numpy and the native repair and polish release the
        interpreter lock for their heavy loops) while the next instance
        solves; their exceptions re-raise at the end.  The device solve reads
        nothing back on the host; its packed result is copied to the host at
        once, the one copy (and the one sync) an entry makes.
        On the CPU the same code runs and the copies are no-ops.

        ``microbatch > 1`` stacks consecutive instances into one batch (the
        last one ragged where the count does not divide) and splits the
        results back.

        Each instance is one request of the tracer (``tracing``): the
        workers' spans ``lapgnn.stream.pack``, ``.upload`` and ``.certify``
        and the main thread's ``lapgnn.stream.solve`` (its wait for the
        upload, ``lapgnn.stream.wait_upload``, the device solve and the
        readback inside) and ``lapgnn.stream.wait_certify`` carry its
        request id."""
        if self.mode != "device":
            raise ValueError("solve_stream requires mode='device'")
        costs = list(costs)
        if microbatch > 1:
            chunks = [
                np.stack([_host_array(c) for c in costs[i : i + microbatch]])
                for i in range(0, len(costs), microbatch)
            ]
            outs = []
            for cr in self.solve_stream(chunks, certify):
                for b in range(cr["col_of_row"].shape[0]):
                    outs.append({k: v[b : b + 1] for k, v in cr.items()})
            return outs
        DEPTH = 3
        copy_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        pack_pool = ThreadPoolExecutor(max_workers=1)
        upload_pool = ThreadPoolExecutor(max_workers=1)
        cert_pool = ThreadPoolExecutor(max_workers=2) if certify else None
        pack_futures: list = []
        upload_futures: list = []
        cert_futures: list = []
        results = []
        requests = [tracing.new_request() for _ in costs]

        def pack(k):
            with tracing.span("stream.pack", request=requests[k]):
                return self._pack(costs[k])

        def upload(k):
            host = pack_futures[k].result()
            with tracing.span("stream.upload", request=requests[k]):
                # the pinned host buffer stays referenced with its upload
                return self._upload(host, copy_stream) + (host,)

        def certify_one(k, c_np, packed, out):
            with tracing.span("stream.certify", request=requests[k]):
                self._certify_and_polish(c_np, packed, out)

        try:
            for k in range(len(costs)):
                while len(pack_futures) < min(len(costs), k + DEPTH + 1):
                    pack_futures.append(pack_pool.submit(pack, len(pack_futures)))
                while len(upload_futures) < min(len(costs), k + DEPTH):
                    upload_futures.append(upload_pool.submit(upload, len(upload_futures)))
                with tracing.span("stream.solve", self.device, request=requests[k]):
                    with tracing.span("stream.wait_upload"):
                        payload, event, _pinned = upload_futures[k].result()
                    upload_futures[k] = pack_futures[k] = None
                    if event is not None:
                        current = torch.cuda.current_stream(self.device)
                        current.wait_event(event)
                        _map_payload(lambda t: t.record_stream(current), payload)
                    packed = self._read_back(self._e2e(payload))
                del payload, _pinned  # the copy above waited for the upload
                c_np = _host_f64(costs[k])
                out = self._unpack(packed, c_np.shape[-1])
                if certify:
                    cert_futures.append(cert_pool.submit(certify_one, k, c_np, packed, out))
                results.append(out)
            for k, f in enumerate(cert_futures):
                with tracing.span("stream.wait_certify", request=requests[k]):
                    f.result()  # re-raises a worker's exception
        finally:
            pack_pool.shutdown(wait=True)
            upload_pool.shutdown(wait=True)
            if cert_pool is not None:
                cert_pool.shutdown(wait=True)
        return results

    def _pack(self, cost) -> Payload:
        """``_to_xfer`` of one stream entry, in pinned memory when the device
        is a GPU (so that its upload can be asynchronous)."""
        host = self._to_xfer(_host_array(cost))
        if self.device.type != "cuda":
            return host
        return _map_payload(lambda t: t.pin_memory(), host)

    def _upload(self, host: Payload, stream) -> Tuple[Payload, Optional["torch.cuda.Event"]]:
        """Copy a packed payload to the device.  With a CUDA ``stream`` the
        copies are issued on it without blocking, and an event recorded
        after them is returned; on the CPU (``stream`` None) the copy is a
        no-op and the event None."""
        if stream is None:
            return _map_payload(lambda t: t.to(self.device), host), None
        with torch.cuda.stream(stream):
            dev = _map_payload(lambda t: t.to(self.device, non_blocking=True), host)
            event = torch.cuda.Event()
            event.record(stream)
        return dev, event

    def _solve_host_route(self, cost64: np.ndarray, certify: bool) -> Dict[str, np.ndarray]:
        """Host route: cold native JV up to ``route_native_max_n``, SciPy
        above it; float64 end to end.  When the native solver fails in any
        way (no compiler, a library that does not load, a solve error),
        SciPy answers the rest of the batch, as in the JAX pipeline."""
        import scipy.optimize

        from .solver.native import lapjv_native

        B, n, _ = cost64.shape
        xs, cs = [], []
        use_native = n <= self.route_native_max_n
        for b in range(B):
            if use_native:
                try:
                    x, _, c = lapjv_native(cost64[b])
                except Exception:  # the JAX pipeline's catch
                    use_native = False
            if not use_native:
                _, x = scipy.optimize.linear_sum_assignment(cost64[b])
                c = float(cost64[b][np.arange(n), x].sum())
            xs.append(np.asarray(x, np.int64))
            cs.append(float(c))
        out = {
            "col_of_row": np.stack(xs),
            "cost": np.asarray(cs),
            "used_fallback": np.zeros(B, bool),
            "routed_host": np.ones(B, bool),
        }
        if certify:
            _add_trivial_certificate(out)
        return out

    @tracing.spanned("e2e", lambda self, payload: self.device)
    def _e2e(self, payload: Payload) -> torch.Tensor:
        """Decode, predict, then the seeded float32 solve instance by
        instance on the device (as the JAX serving program's ``lax.scan``);
        returns the packed (B, 2 + 2n) float32 result ``[cost,
        used_fallback, col_of_row, v]`` on the device, for one copy to the
        host (pipeline.py:440-489 of the JAX version).  Nothing is read back
        before that copy: ``last_solve_stats`` keeps each instance's loop
        counts on the device until a caller reads them."""
        with tracing.span("decode", self.device):
            cost_t = _decode_transfer(payload)
        u, v = self._predict(cost_t)
        self.last_solve_stats = []
        rows = []
        with torch.inference_mode():
            for b in range(cost_t.shape[0]):
                stats = SolveStats()
                res = lapjv_seeded_single(
                    cost_t[b], u[b], v[b], eps=self.eps, gate=self.gate, stats=stats
                )
                self.last_solve_stats.append(stats)
                rows.append(torch.cat([
                    res.cost[None].to(torch.float32),
                    res.used_fallback[None].to(torch.float32),
                    res.col_of_row.to(torch.float32),
                    res.v.to(torch.float32),
                ]))
            return torch.stack(rows)

    @staticmethod
    def _unpack(packed: np.ndarray, n: int) -> Dict[str, np.ndarray]:
        return {
            "col_of_row": packed[:, 2 : 2 + n].astype(np.int64),
            "cost": packed[:, 0].astype(np.float64),
            "used_fallback": packed[:, 1] > 0.5,
        }

    @tracing.spanned("certify")
    def _certify_and_polish(
        self, cost_np: np.ndarray, packed: np.ndarray, out: Dict[str, np.ndarray]
    ) -> None:
        """Float64 exactness pass against the true cost matrix, in place
        (pipeline.py:656 of the JAX version).  Cheapest sufficient proof
        first:
          1. the raw certificate with the device duals as they are;
          2. the native dual repair (``repair_duals_native``), which succeeds
             iff the device assignment is exactly optimal for the true
             matrix;
          3. the native float64 solve warm-started from the device duals, and
             the cold native solve if that fails its own certificate or the
             device result is unusable (NaN duals, not a permutation).
        Certified entries take the f64 cost of their assignment.  Adds
        'certified', 'gap_bound', 'repaired', 'polished', 'polish_ms'."""
        from .solver.native import (
            NativeSolveError,
            lapjv_native,
            lapjv_seeded_native,
            repair_duals_native,
        )
        from .solver.verification import certify_assignment

        B, n = packed.shape[0], cost_np.shape[-1]
        v_all = packed[:, 2 + n :].astype(np.float64)
        certified = np.zeros(B, bool)
        gap_bound = np.zeros(B)
        repaired = np.zeros(B, bool)
        polished = np.zeros(B, bool)
        polish_ms = np.zeros(B)
        for b in range(B):
            x_b = out["col_of_row"][b]
            usable = (
                np.array_equal(np.sort(x_b), np.arange(n)) and np.isfinite(v_all[b]).all()
            )
            ok, _, bound = certify_assignment(cost_np[b], x_b, v_all[b], tol=self.certify_tol)
            if not ok and usable:
                try:
                    rep = repair_duals_native(cost_np[b], x_b, v_all[b])
                except NativeSolveError:
                    rep = None  # no toolchain: the polish below decides
                if rep is not None and np.isfinite(rep[1]):
                    viol = max(0.0, -rep[1])
                    ok = viol <= self.certify_tol
                    bound = n * viol
                    repaired[b] = ok
            certified[b], gap_bound[b] = ok, bound
            if ok:
                out["cost"][b] = float(cost_np[b][np.arange(n), x_b].sum())
                continue
            t0 = time.perf_counter()
            if usable:
                u_b = cost_np[b][np.arange(n), x_b] - v_all[b][x_b]
                x, _, c, info = lapjv_seeded_native(
                    cost_np[b], u_b, v_all[b], eps=self.eps, gate=self.gate,
                    return_info=True,
                )
                v_fin = info["v"]
            else:
                x, _, c, _, v_fin = lapjv_native(cost_np[b], return_duals=True)
            ok2, _, bound2 = certify_assignment(cost_np[b], x, v_fin, tol=self.certify_tol)
            if not ok2 and usable:
                x, _, c, _, v_fin = lapjv_native(cost_np[b], return_duals=True)
                ok2, _, bound2 = certify_assignment(cost_np[b], x, v_fin, tol=self.certify_tol)
            out["col_of_row"][b] = x
            out["cost"][b] = c
            certified[b], gap_bound[b] = ok2, bound2
            polished[b] = True
            polish_ms[b] = (time.perf_counter() - t0) * 1e3
        out["certified"] = certified
        out["gap_bound"] = gap_bound
        out["repaired"] = repaired
        out["polished"] = polished
        out["polish_ms"] = polish_ms

    def _solve_hybrid(self, cost, payload: Payload) -> Dict[str, np.ndarray]:
        """GPU predict from the decoded transfer image (as the JAX version
        does, pipeline.py:902), one stacked (B, 2, n) device-to-host copy of
        (u, v), then the float64 native seeded solve of the true matrix per
        instance."""
        from .solver.native import lapjv_seeded_native

        u, v = self._predict(_decode_transfer(payload))
        packed_uv = tracing.to_host(torch.stack([u, v], dim=1)).numpy()
        u_np = packed_uv[:, 0, :].astype(np.float64)
        v_np = packed_uv[:, 1, :].astype(np.float64)
        cost_np = _host_f64(cost)
        xs, costs, fbs = [], [], []
        for b in range(cost_np.shape[0]):
            x, _, c, info = lapjv_seeded_native(
                cost_np[b], u_np[b], v_np[b], eps=self.eps, return_info=True,
                gate=self.gate,
            )
            xs.append(x)
            costs.append(c)
            fbs.append(info["used_fallback"])
        return {
            "col_of_row": np.stack(xs),
            "cost": np.asarray(costs),
            "used_fallback": np.asarray(fbs),
        }


def _host_array(cost) -> np.ndarray:
    """A host view of an array or a tensor (a GPU tensor is copied; numpy has
    no bfloat16, so a bfloat16 tensor comes back as float32)."""
    if isinstance(cost, torch.Tensor):
        t = cost.detach()
        t = tracing.to_host(t) if t.device.type != "cpu" else t
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(cost)


def _host_f64(cost) -> np.ndarray:
    c = np.asarray(_host_array(cost), np.float64)
    return c if c.ndim == 3 else c[None]


def _add_trivial_certificate(out: Dict[str, np.ndarray]) -> None:
    B = len(out["cost"])
    out["certified"] = np.ones(B, bool)
    out["gap_bound"] = np.zeros(B)
    out["repaired"] = np.zeros(B, bool)
    out["polished"] = np.zeros(B, bool)
    out["polish_ms"] = np.zeros(B)
