"""Every kernel wrapper of the port launches on its operands' device and on
that device's current stream.

The launches are mocked: the operands are fake tensors on cuda:1
(torch's FakeTensorMode, which needs no card), each library's ctypes
functions are replaced by a recorder, and torch.cuda.device and
torch.cuda.current_stream by fakes that note the device made current and
hand out one stream handle per device. A wrapper that took the current
device's stream, or launched outside its operands' device context, would
hand the launch cuda:0's stream while the device made current is the
default one; this test sees that. The card twin is in
tests/test_torch_cuda.py (test_wrappers_launch_on_the_current_stream).
"""

import contextlib
import types
import warnings

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from karpenter_tpu_torch.ops import (
    consolidate_kernel,
    cuda_build,
    cuda_kernels,
    forecast_kernel,
    incremental,
    lp_shard_kernel,
    pack_kernel,
    score_kernel,
)

torch.set_num_threads(2)

DEVICE = torch.device("cuda", 1)
STREAM_BASE = 7000  # the fake stream handle of cuda:i is STREAM_BASE + i
SMS = 132  # the fake card's streaming multiprocessors


class _Recorder:
    """The fakes: a stack of devices made current, and every library call
    with its arguments and the device current at the call."""

    def __init__(self):
        self.current = [torch.device("cuda", 0)]
        self.calls = []
        self.streams_asked = []  # the device argument of each current_stream call

    def device(self, device):
        recorder = self

        @contextlib.contextmanager
        def entered():
            recorder.current.append(torch.device(device))
            try:
                yield
            finally:
                recorder.current.pop()

        return entered()

    def current_stream(self, device=None):
        self.streams_asked.append(device)
        device = self.current[-1] if device is None else torch.device(device)

        class Stream:
            cuda_stream = STREAM_BASE + device.index

        return Stream()


class _Launched(Exception):
    """Raised by the recorded launch: the wrapper stops there, before it
    reads outputs that the mock never wrote."""


class _FakeLibrary:
    def __init__(self, recorder):
        self._recorder = recorder

    def __getattr__(self, name):
        recorder = self._recorder

        def call(*args):
            if name.endswith(("_words", "_bytes", "_threads")):
                return 64
            recorder.calls.append((name, args, recorder.current[-1]))
            raise _Launched(name)

        return call


LIBRARIES = [
    cuda_kernels.LIBRARY, pack_kernel.LIBRARY, pack_kernel.LEVELS_LIBRARY,
    pack_kernel.COMPACT_SHARD_LIBRARY, score_kernel.LIBRARY,
    consolidate_kernel.LIBRARY, incremental.LIBRARY, forecast_kernel.LIBRARY,
    lp_shard_kernel.LIBRARY,
]


@pytest.fixture
def recorder(monkeypatch):
    recorder = _Recorder()
    monkeypatch.setattr(torch.cuda, "device", recorder.device)
    monkeypatch.setattr(torch.cuda, "current_stream", recorder.current_stream)
    for library in LIBRARIES:
        monkeypatch.setattr(library, "load", lambda recorder=recorder: _FakeLibrary(recorder))
    monkeypatch.setattr(
        score_kernel, "_bias_table",
        lambda steps, device: torch.zeros((max(steps, 1), 2), device=device),
    )
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: types.SimpleNamespace(multi_processor_count=SMS))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # a fake tensor's data_ptr warns
        with FakeTensorMode(allow_non_fake_inputs=True):
            yield recorder


def _f32(*shape):
    return torch.zeros(shape, dtype=torch.float32, device=DEVICE)


def _i32(*shape):
    return torch.zeros(shape, dtype=torch.int32, device=DEVICE)


def _bool(*shape):
    return torch.zeros(shape, dtype=torch.bool, device=DEVICE)


def _rounds(groups):
    mr = pack_kernel.max_rounds(groups)
    return pack_kernel.PackRounds(_i32(mr), _i32(mr, groups), _i32(mr), _i32(), _i32(groups), _i32())


G, T, R, L = 16, 64, 8, 2


def _launch(name):
    """One call of the wrapper `name` on cuda:1 operands."""
    if name == "dominance_prices":
        cuda_kernels.dominance_prices(_f32(T, R), _f32(T))
    elif name == "pack_kernel":
        pack_kernel.pack_kernel(_f32(G, R), _i32(G), _f32(T, R), _f32(T, R), _bool(T), _f32(T))
    elif name == "pack_kernel_pair":
        pack_kernel.pack_kernel_pair(_f32(G, R), _i32(G), _f32(T, R), _f32(T, R), _bool(T), _f32(T))
    elif name == "lp_relax":
        score_kernel.lp_relax(_f32(G, R), _i32(G), _f32(T, R), _bool(T), _f32(T), steps=3)
    elif name == "pack_pair_payload":
        pack_kernel.pack_pair_payload(_f32(G, R), _i32(G), _f32(T, R), _f32(T, R), _bool(T), _f32(T))
    elif name == "pack_kernel_levels":
        pack_kernel.pack_kernel_levels(
            _f32(G, R), _i32(L, G), _f32(T, R), _f32(T, R), _bool(T), _f32(T), _bool(L, G, T),
            _f32(L, G, T), _bool(G, G), _i32(G),
        )
    elif name == "solve_counterfactuals":
        C, N = 4, 32
        consolidate_kernel.solve_counterfactuals(
            _f32(C, G, R), _i32(C, G), _f32(N, R), _bool(C, N), _f32(T, R), _f32(T), _bool(C, T),
            _f32(C), _bool(C),
        )
    elif name == "scatter":
        incremental.scatter(_f32(32, R), _i32(8), _f32(8, R))
    elif name == "gather":
        incremental.gather(_f32(32, R), _i32(8))
    elif name == "scatter_flush":
        incremental.scatter_flush([(_f32(32, R), _i32(8), _f32(8, R)), (_i32(32), _i32(8), _i32(8)),
                                   (_f32(16, 3), _i32(4), _f32(4, 3)), (_bool(16), _i32(4), _bool(4))])
    elif name == "gather_view":
        incremental.gather_view([_f32(32, R), _i32(32), _bool(32, 2)], _i32(16))
    elif name == "penalize_prices":
        forecast_kernel.penalize_prices(_f32(T), _f32(T), 0.5)
    elif name == "shard_softmax":
        cells = [_f32(G, T) for _ in range(5)]
        lp_shard_kernel.shard_softmax(*cells, _bool(G, T), _f32(G), _f32(G), _f32(2))
    elif name == "shard_demand":
        lp_shard_kernel.shard_demand(_f32(G, T), _bool(G, T), _f32(G), _f32(G, R), _f32(G), _f32(G, T))
    elif name == "shard_row_dot":
        lp_shard_kernel.shard_row_dot(
            _f32(G, T), _f32(G, T), _bool(G, T), _f32(G), _f32(G, R), _f32(T, R), _f32(T), _f32(T, R),
        )
    elif name == "shard_lp":
        S, rows, cols = 8, G // 2, T // 4
        cells = [_f32(S, rows, cols) for _ in range(3)]
        lp_shard_kernel.shard_lp(_f32(2, rows, R), _f32(2, rows), _f32(4, cols, R), _f32(4, cols),
                                 _bool(S, rows, cols), *cells, _f32(300, 2), 300, (2, 4))
    elif name == "compact_shard":
        mr = pack_kernel.max_rounds(G)
        pack_kernel.compact_shard(_i32(mr, G), _i32(mr, G), 1, 4)
    elif name == "compact_shards":
        mr = pack_kernel.max_rounds(G)
        pack_kernel.compact_shards(_i32(mr, G), _i32(mr, G), [1, 3], 4)
    elif name == "compact_sharded_payload":
        pack_kernel.compact_sharded_payload(_rounds(G), _rounds(G), _bool(G), 8)
    else:
        raise KeyError(name)


WRAPPERS = [
    "dominance_prices", "pack_kernel", "pack_kernel_pair", "lp_relax", "pack_pair_payload",
    "pack_kernel_levels", "solve_counterfactuals", "scatter", "gather", "penalize_prices",
    "shard_softmax", "shard_demand", "shard_row_dot", "shard_lp", "compact_shard",
    "scatter_flush", "gather_view", "compact_shards", "compact_sharded_payload",
]


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_launches_on_its_operands_device_and_stream(name, recorder):
    with pytest.raises(_Launched):
        _launch(name)
    assert len(recorder.calls) == 1, f"{name} made {len(recorder.calls)} launches"
    for function, args, current in recorder.calls:
        assert current == DEVICE, f"{function} launched with {current} current"
        assert args[-1] == STREAM_BASE + DEVICE.index, (
            f"{function} got stream {args[-1]}, not cuda:1's current stream"
        )
    assert recorder.current == [torch.device("cuda", 0)]
    assert recorder.streams_asked == [DEVICE], "the stream is asked for by the operands' device"


def test_operands_on_two_devices_raise():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with FakeTensorMode(allow_non_fake_inputs=True):
            first = torch.zeros(4, device="cuda:0")
            second = torch.zeros(4, device="cuda:1")
            with pytest.raises(ValueError, match="span devices"):
                with cuda_build.launch_stream("k", (first, second)):
                    pass


def test_every_library_is_mocked():
    """The recorder covers every kernel source the port builds."""
    assert {lib.source.name for lib in LIBRARIES} == {
        lib.source.name for lib in cuda_build.port_libraries()
    }
    assert np.unique([lib.source.name for lib in LIBRARIES]).size == len(LIBRARIES)


@pytest.mark.parametrize("payload", [True, False])
def test_pair_payload_launch_carries_the_epilogue(payload, recorder, monkeypatch):
    """K2's pair launch with its epilogue: both modes in one launch whose
    outputs are the dense spill (both modes' words and G more), feasible_any,
    solvable and, unless it is left off (a mesh's replicas), the payload."""
    handed = []
    real = pack_kernel.launch_stream

    def spy(kernel, tensors):
        handed.append(list(tensors))
        return real(kernel, tensors)

    monkeypatch.setattr(pack_kernel, "launch_stream", spy)
    with pytest.raises(_Launched):
        pack_kernel.pack_pair_payload(_f32(G, R), _i32(G), _f32(T, R), _f32(T, R), _bool(T), _f32(T),
                                      payload=payload)
    ((function, args, _),) = recorder.calls
    assert function == "ktt_pack_rounds"
    # After the six operands: G, T, R, first mode, modes.
    assert args[6:11] == (G, T, R, 0, 2)
    words = 64  # the fake library's ktt_pack_rounds_words
    outputs = [(t.dtype, tuple(t.shape)) for t in handed[0][6:]]
    want = [(torch.int32, (2 * words + G,)), (torch.bool, (G,)), (torch.int32, (G,))]
    if payload:
        want.append((torch.int32, (pack_kernel.compact_words(G),)))
    assert outputs == want


def test_levels_launch_carries_its_cluster_plan(recorder):
    """K6 launches one cluster a level with the plan's cluster size, lanes
    and threads."""
    with pytest.raises(_Launched):
        _launch("pack_kernel_levels")
    ((function, args, _),) = recorder.calls
    assert function == "ktt_pack_levels"
    plan = pack_kernel.levels_launch_plan(G, T, R)
    # After the nine operands: G, T, R, L, mode, then the plan.
    assert args[9:17] == (G, T, R, L, 1, plan.cluster, plan.lanes, plan.threads)


def test_flush_launch_carries_every_array(recorder):
    """K8's flush: one launch whose table holds every array's row count,
    width, delta length and element size."""
    with pytest.raises(_Launched):
        _launch("scatter_flush")
    ((function, args, _),) = recorder.calls
    assert function == "ktt_scatter_flush" and args[0] == 4
    table = list(args[1])
    rows = [table[8 * k + 4 : 8 * k + 8] for k in range(4)]
    assert rows == [[32, R, 8, 4], [32, 1, 8, 4], [16, 3, 4, 4], [16, 1, 4, 1]]


def test_view_launch_shares_one_permutation(recorder):
    """K8's view: one launch, every source's rows, width and element size
    in its table, the permutation's length beside."""
    with pytest.raises(_Launched):
        _launch("gather_view")
    ((function, args, _),) = recorder.calls
    assert function == "ktt_gather_view" and args[0] == 3 and args[3] == 16
    table = list(args[1])
    assert [table[5 * k + 2 : 5 * k + 5] for k in range(3)] == [[32, R, 4], [32, 1, 4], [32, 2, 1]]


def test_sharded_payload_launch_covers_every_shard(recorder):
    """K9b's one-card route: one launch with G, the shard count and the
    shard budget; the per-card route lists its shards."""
    with pytest.raises(_Launched):
        _launch("compact_sharded_payload")
    with pytest.raises(_Launched):
        _launch("compact_shards")
    (payload, _, _), (shards, shard_args, _) = recorder.calls
    assert payload == "ktt_compact_sharded_payload"
    assert recorder.calls[0][1][2:5] == (G, 8, pack_kernel.shard_entry_budget(G, 8))
    assert shards == "ktt_compact_shards"
    assert shard_args[2:6] == (G, 4, pack_kernel.shard_entry_budget(G, 4), 2)
    assert list(shard_args[6]) == [1, 3]


def test_persistent_lp_launch_carries_its_tiling(recorder):
    """K9a's persistent kernel: one cooperative launch with the plan's
    tiling of the mesh's shard blocks."""
    with pytest.raises(_Launched):
        _launch("shard_lp")
    ((function, args, _),) = recorder.calls
    assert function == "ktt_lp_shard_persistent"
    plan = lp_shard_kernel.lp_shard_launch_plan(8, G // 2, T // 4, R, SMS)
    # After the seventeen pointers: the mesh, a shard's block, R, the
    # steps, the tiling and the final pass.
    assert args[17:28] == (2, 4, G // 2, T // 4, R, 300, plan.row_tiles, plan.col_tiles,
                           plan.tile_rows, plan.tile_cols, 1)
