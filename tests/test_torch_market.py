"""The port's live market against the JAX reference, on the CPU.

K10's plain version (`ops/forecast_kernel._penalize_prices_ref`, what
`market/forecast.penalize_prices_torch` runs on a CPU tensor) is held bit
for bit to the reference's numpy column and to its jax mirror. One seeded
feed is folded into both packages' PriceBooks (and through `convert`'s
wire form and book state): generations, risks, reprices and advertised
prices equal. Under a risky book, `build_fleet`'s [T] prices and
`_pool_price_matrix`'s [T, Z] ranking are bit-identical to the reference's,
and `DeviceClusterState.encode_fleet` misses on a reprice and a risk move
and hits while the market is calm.

Tolerances: none. Every comparison here is exact (bits or equality).
"""

import numpy as np
import pytest
import torch

from karpenter_tpu.cloudprovider.fake import FakeCloudProvider as RefFakeCloud
from karpenter_tpu.market import feed as ref_feed
from karpenter_tpu.market import forecast as ref_forecast
from karpenter_tpu.market import pricebook as ref_pricebook
from karpenter_tpu.models import solver as ref_solver
from karpenter_tpu.ops import encode as ref_encode
from karpenter_tpu.utils.clock import FakeClock as RefFakeClock
from karpenter_tpu_torch import convert
from karpenter_tpu_torch.api.provisioner import ProvisionerSpec
from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider
from karpenter_tpu_torch.controllers.cluster import Cluster
from karpenter_tpu_torch.market import feed as port_feed
from karpenter_tpu_torch.market import forecast as port_forecast
from karpenter_tpu_torch.market import pricebook as port_pricebook
from karpenter_tpu_torch.models import solver as port_solver
from karpenter_tpu_torch.models.cluster_state import DeviceClusterState
from karpenter_tpu_torch.ops import encode as port_encode
from karpenter_tpu_torch.ops import forecast_kernel
from karpenter_tpu_torch.utils.clock import FakeClock

import chip_smoke

torch.set_num_threads(2)

NUM_TYPES = 24
FEED_SEED = 5


@pytest.fixture(autouse=True)
def _port_book_reset():
    """The port's active PriceBook is process-global like the reference's
    (whose own reset lives in tests/conftest.py): a book leaking into a
    later port test on this worker would reprice its fleets."""
    port_pricebook.set_active_book(None)
    yield
    port_pricebook.set_active_book(None)


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _catalogs():
    """The main path's catalog shape at 24 types, in both packages."""
    from karpenter_tpu import cloudprovider as ref_cloud

    ref_package = chip_smoke.port_package()
    ref_package.InstanceType, ref_package.Offering = ref_cloud.InstanceType, ref_cloud.Offering
    return (chip_smoke.make_catalog(NUM_TYPES, package=ref_package),
            chip_smoke.make_catalog(NUM_TYPES))


# --- K10: the plain version against the reference ---------------------------------


def _k10_inputs(size: int = 257, seed: int = 9):
    rng = np.random.default_rng(seed)
    prices = rng.uniform(0.01, 64.0, size=size).astype(np.float32)
    risks = (np.floor(rng.uniform(0.0, 1.0, size=size) * 32.0) / 32.0).astype(np.float32)
    return prices, risks


@pytest.mark.parametrize("seed", [9, 10, 11])
def test_k10_plain_is_bit_identical_to_the_reference(seed):
    prices, risks = _k10_inputs(seed=seed)
    host = ref_forecast.penalize_prices(prices, risks)
    jax_mirror = np.asarray(ref_forecast.penalize_prices_jnp(prices, risks))
    plain = forecast_kernel._penalize_prices_ref(
        torch.from_numpy(prices), torch.from_numpy(risks), port_forecast.RISK_PRICE_WEIGHT
    ).numpy()
    mirror = port_forecast.penalize_prices_torch(prices, risks).numpy()
    assert _same_bits(plain, host) and _same_bits(plain, jax_mirror) and _same_bits(mirror, host)
    assert _same_bits(port_forecast.penalize_prices(prices, risks), host)


def test_k10_plain_is_the_identity_at_zero_risk():
    prices, _ = _k10_inputs()
    zero = np.zeros_like(prices)
    got = port_forecast.penalize_prices_torch(torch.from_numpy(prices), zero)
    assert _same_bits(got.numpy(), prices)


def test_k10_wrapper_routes_cpu_tensors_to_the_plain_version():
    prices, risks = _k10_inputs(size=16)
    before = forecast_kernel.penalize_prices.launches
    out = forecast_kernel.penalize_prices(torch.from_numpy(prices), torch.from_numpy(risks), 1.0)
    assert out.device.type == "cpu" and forecast_kernel.penalize_prices.launches == before
    with pytest.raises(TypeError):
        forecast_kernel.penalize_prices(torch.from_numpy(prices).double(), torch.from_numpy(risks), 1.0)
    with pytest.raises(ValueError):
        forecast_kernel.penalize_prices(torch.from_numpy(prices), torch.from_numpy(risks[:8]), 1.0)


# --- the feed and the book, folded by both packages ---------------------------------


def _pools(catalog):
    return port_feed.catalog_pools(catalog)


def _fold_both(steps: int = 6, threshold: float = 0.05):
    """One seeded feed per package over the same pools, stepped alike and
    folded into each package's book; returns (reference, port) as
    (feed, book, reprices)."""
    ref_catalog, port_catalog = _catalogs()
    pools = _pools(port_catalog)
    assert pools == ref_feed.catalog_pools(ref_catalog)
    out = []
    for feed_mod, book_mod, clock in ((ref_feed, ref_pricebook, RefFakeClock()),
                                       (port_feed, port_pricebook, FakeClock())):
        feed = feed_mod.MarketFeed(pools, seed=FEED_SEED, start_at=clock.now(), ice_close_rate=0.02)
        feed.force_spike(pools[:3], 1.6)
        book = book_mod.PriceBook(clock=clock, reprice_threshold=threshold)
        clock.advance(steps * feed.tick_interval_s)
        feed.advance(clock.now())
        reprices = [book.apply(tick) for tick in feed.ticks_after(0)]
        book.note_interruption(pools[4])
        out.append((feed, book, [r for r in reprices if r is not None]))
    return out


def _book_view(book, pools):
    return (
        book.generation, book.risk_generation, book.last_seq, book.fingerprint(),
        book.has_risk(), sorted(book.risk_snapshot().items()),
        [book.spot_discount(p) for p in pools], [book.is_closed(p) for p in pools],
        [book.pool_risk(p) for p in pools],
    )


def test_the_same_feed_folds_to_the_same_book():
    (ref_f, ref_book, ref_reprices), (port_f, port_book, port_reprices) = _fold_both()
    assert ref_f.encode_history() == port_f.encode_history()
    pools = port_f.pools
    assert _book_view(ref_book, pools) == _book_view(port_book, pools)
    assert ref_book.generation > 0 and port_book.has_risk()
    assert [(r.pool, r.reason, r.old_discount, r.new_discount, r.generation) for r in ref_reprices] == [
        (r.pool, r.reason, r.old_discount, r.new_discount, r.generation) for r in port_reprices
    ]
    for pool in pools:
        for ct, catalog_price, od in (("spot", 0.31, 1.2), ("spot", 0.5, None), ("on-demand", 1.2, 1.2)):
            assert ref_pricebook.advertised_price(ref_book, pool, ct, catalog_price, od) == \
                port_pricebook.advertised_price(port_book, pool, ct, catalog_price, od)


def test_convert_carries_ticks_and_book_state():
    """The reference's ticks in wire form fold into the port's book to the
    same state, and a reference book's state rebuilds as the port's book."""
    (ref_f, ref_book, _), _ = _fold_both()
    clock = FakeClock()
    replayed = port_pricebook.PriceBook(clock=clock, reprice_threshold=0.05)
    ticks = convert.market_ticks(ref_f.encode_history())
    assert [t.encode() for t in ticks] == ref_f.encode_history()
    for tick in ticks:
        replayed.apply(tick)
    carried = convert.pricebook_from_state(convert.pricebook_state(ref_book), clock=clock)
    state = convert.pricebook_state(carried)
    assert state == convert.pricebook_state(ref_book)
    pools = ref_f.pools
    assert _book_view(carried, pools) == _book_view(ref_book, pools)
    # The replay lacks only the noted interruption.
    assert replayed.generation == ref_book.generation and replayed.last_seq == ref_book.last_seq


def test_advertised_catalog_matches_the_reference():
    (ref_f, ref_book, _), (port_f, port_book, _) = _fold_both()
    ref_catalog, port_catalog = _catalogs()
    ref_cloud = RefFakeCloud(instance_types=ref_catalog, clock=RefFakeClock())
    port_cloud = FakeCloudProvider(instance_types=port_catalog, clock=FakeClock())
    ref_cloud.attach_market(ref_book)
    port_cloud.attach_market(port_book)

    def offerings(cloud):
        return [(it.name, o.zone, o.capacity_type, o.price)
                for it in cloud.get_instance_types() for o in it.offerings]

    assert offerings(ref_cloud) == offerings(port_cloud)


# --- the hooks: build_fleet's column, the pool matrix, the fleet cache -------------


def _fleets(books, active: bool = True):
    """build_fleet and the pool matrix in both packages on the catalog each
    cloud advertises under `books` (reference book, port book), with the
    books active (or, active=False, none: the penalty hooks off)."""
    from karpenter_tpu.api.provisioner import ProvisionerSpec as RefProvisionerSpec

    ref_catalog, port_catalog = _catalogs()
    ref_cloud = RefFakeCloud(instance_types=ref_catalog, clock=RefFakeClock())
    port_cloud = FakeCloudProvider(instance_types=port_catalog, clock=FakeClock())
    ref_cloud.attach_market(books[0])
    port_cloud.attach_market(books[1])
    if active:
        ref_pricebook.set_active_book(books[0])
        port_pricebook.set_active_book(books[1])
    try:
        need = np.zeros(8, np.float32)
        ref_fleet = ref_encode.build_fleet(
            ref_cloud.get_instance_types(), RefProvisionerSpec().constraints, [], pods_need=need)
        port_fleet = port_encode.build_fleet(
            port_cloud.get_instance_types(), ProvisionerSpec().constraints, [], pods_need=need)
        return (ref_fleet, ref_solver._pool_price_matrix(ref_fleet)), \
            (port_fleet, port_solver._pool_price_matrix(port_fleet))
    finally:
        ref_pricebook.set_active_book(None)
        port_pricebook.set_active_book(None)


def test_risky_book_prices_match_the_reference_bit_for_bit():
    (_, ref_book, _), (_, port_book, _) = _fold_both()
    assert ref_book.has_risk() and port_book.has_risk()
    (ref_fleet, (ref_zones, ref_matrix)), (port_fleet, (port_zones, port_matrix)) = _fleets(
        (ref_book, port_book))
    assert port_fleet.capacity_type == "spot"
    assert [it.name for it in ref_fleet.instance_types] == [it.name for it in port_fleet.instance_types]
    assert _same_bits(ref_fleet.prices, port_fleet.prices)
    assert ref_zones == port_zones and _same_bits(ref_matrix, port_matrix)
    # ... and the penalty moved them: off, the column is lower exactly where
    # a type carries risk, and the same bits elsewhere.
    (_, _), (calm_fleet, (_, calm_matrix)) = _fleets((ref_book, port_book), active=False)
    risks = port_forecast.type_risks(
        [it.name for it in port_fleet.instance_types],
        [sorted(it.zones()) for it in port_fleet.instance_types], port_book)
    risked = risks > 0
    assert risked.any() and (port_fleet.prices[risked] > calm_fleet.prices[risked]).all()
    assert _same_bits(port_fleet.prices[~risked], calm_fleet.prices[~risked])
    assert _same_bits(port_forecast.penalize_prices(calm_fleet.prices, risks), port_fleet.prices)
    assert np.array_equal(np.isinf(port_matrix), np.isinf(calm_matrix))


def test_calm_book_is_bit_identical_to_no_book():
    """A book with no risk (one snapshot tick a pool) leaves the fleet's
    column and the pool matrix as no book at all would, on the catalog it
    advertises."""
    _, port_catalog = _catalogs()
    pools = _pools(port_catalog)
    clock = FakeClock()
    feed = port_feed.MarketFeed(pools, seed=FEED_SEED, start_at=clock.now())
    book = port_pricebook.PriceBook(clock=clock)
    for tick in feed.ticks_after(0):
        book.apply(tick)
    assert not book.has_risk()
    cloud = FakeCloudProvider(instance_types=port_catalog, clock=clock)
    cloud.attach_market(book)
    advertised = cloud.get_instance_types()
    need = np.zeros(8, np.float32)
    columns = []
    for active in (book, None):
        port_pricebook.set_active_book(active)
        fleet = port_encode.build_fleet(advertised, ProvisionerSpec().constraints, [], pods_need=need)
        columns.append((fleet.prices, port_solver._pool_price_matrix(fleet)[1]))
    assert _same_bits(columns[0][0], columns[1][0]) and _same_bits(columns[0][1], columns[1][1])


def test_encode_fleet_misses_on_reprice_and_risk_and_hits_while_calm():
    clock = FakeClock()
    book = port_pricebook.PriceBook(clock=clock, reprice_threshold=0.1)
    port_pricebook.set_active_book(book)
    state = DeviceClusterState(Cluster(clock=clock), device="cpu")
    _, catalog = _catalogs()
    constraints = ProvisionerSpec().constraints
    pool = _pools(catalog)[0]

    def tick(seq, discount):
        return port_feed.MarketTick(seq=seq, kind=port_feed.TICK_PRICE, instance_type=pool[0],
                                    zone=pool[1], discount=discount, depth=1.0, at=clock.now())

    first = state.encode_fleet(catalog, constraints, (), None)
    assert state.encode_fleet(catalog, constraints, (), None) is first
    book.apply(tick(1, 0.5))
    assert book.generation == 0
    calm = state.encode_fleet(catalog, constraints, (), None)
    assert state.encode_fleet(catalog, constraints, (), None) is calm
    book.apply(tick(2, 0.9))  # a reprice: generation bump
    assert book.generation == 1
    second = state.encode_fleet(catalog, constraints, (), None)
    assert second is not calm
    assert state.encode_fleet(catalog, constraints, (), None) is second
    book.note_interruption(pool)  # a risk move
    third = state.encode_fleet(catalog, constraints, (), None)
    assert third is not second
    assert state.encode_fleet(catalog, constraints, (), None) is third
    risky_index = [it.name for it in third.instance_types].index(pool[0])
    assert third.prices[risky_index] > second.prices[risky_index]
