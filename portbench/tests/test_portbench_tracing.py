"""``tracing.reduce`` card by card, on hand-built chrome-trace events: one
card reads the numbers it always has, to the last digit; on four cards a
card that idles while the others work shows in ``device_idle_pct``, which
the union of every card's busy time would hide."""
import pytest
from test_portbench_spans import X, trace_events, user

from portbench import harness, tracing

K = "void chain_tick_kernel<16, 2, 4>(int)"

#: what ``reduce`` read from ``trace_events()`` before it went card by card
ONE_CARD = {
    "window_s": 0.00019999999999999998, "busy_s": 0.00016199999999999998, "calls": 1,
    "kernels": 7, "kernel_s": 0.00016199999999999998,
    "breakdown": {
        "device_ops": [["chain_tick_kernel<16, 2, 4>", 0.000157],
                       ["at::native::fill_kernel<int>", 4e-06], ["other_kernel", 1e-06]],
        "idle_gaps": [["synchronise before at::native::fill_kernel<int>",
                       1.9999999999999998e-05],
                      ["between calls before at::native::fill_kernel<int>", 9e-06],
                      ["synchronise before window end", 7e-06],
                      ["synchronise before other_kernel", 2e-06]]}}
NO_DEVICE = {"window_s": 0.00019999999999999998, "busy_s": 0.0, "calls": 1, "kernels": 0,
             "kernel_s": 0.0, "breakdown": {"device_ops": [], "idle_gaps": [
                 ["between calls before window end", 0.00019999999999999998]]}}


def readings(t):
    run = harness.Run()
    run.trace, run.needed_bytes, run.device_name = t, 1 << 30, "NVIDIA H100 80GB HBM3"
    return {m: harness.load_module("metrics", m).read(run)
            for m in ("launches_per_call", "kernel_roofline", "device_idle_pct")}


def test_one_card_reads_what_it_always_has():
    assert tracing.reduce(trace_events()) == ONE_CARD
    assert tracing.reduce(trace_events(), 1) == ONE_CARD
    assert tracing.reduce(trace_events(with_device=False)) == NO_DEVICE
    assert readings(ONE_CARD)["device_idle_pct"] == 19.000000000000007


def four_cards(late_from=150, with_card_3=True):
    """One traced call of 200 us (entry to 40, synchronise from 40 to 199);
    cards 0-2 run a kernel from 5 to 195, card 3 only from ``late_from``."""
    ev = [user("portbench.call", 0, 200), user("portbench.entry", 1, 40),
          user("portbench.sync", 40, 199)]
    for card in range(4 if with_card_3 else 3):
        a = late_from if card == 3 else 5
        ev.append(X(K, "kernel", a, 195 - a, device=card, correlation=card + 1))
    return ev


def test_a_card_that_waits_shows_in_its_idle_share():
    got = tracing.reduce(four_cards(), 4)
    busy = [190, 190, 190, 45]
    assert got["window_s"] == pytest.approx(200e-6)
    assert got["busy_s"] == pytest.approx(sum(busy) / 4 * 1e-6)    # the mean of the cards
    assert got["kernels"] == 4 and got["kernel_s"] == pytest.approx(sum(busy) * 1e-6)
    ops = dict(got["breakdown"]["device_ops"])
    assert ops == {"chain_tick_kernel<16, 2, 4>": pytest.approx(sum(busy) * 1e-6)}
    gaps = dict(got["breakdown"]["idle_gaps"])          # summed card by card
    assert gaps == {"between calls before chain_tick_kernel<16, 2, 4>": pytest.approx(
        (3 * 5 + 150) * 1e-6), "synchronise before window end": pytest.approx(4 * 5e-6)}
    assert sum(gaps.values()) == pytest.approx(4 * 200e-6 - sum(busy) * 1e-6)

    idle = readings(got)["device_idle_pct"]
    per_card = [100 * (1 - b / 200) for b in busy]
    assert idle == pytest.approx(sum(per_card) / 4)                      # 23.125
    as_one = [dict(e, args={}) for e in four_cards()]   # every card read as card 0
    union = tracing.reduce(as_one)
    assert 100 * (1 - union["busy_s"] / union["window_s"]) == pytest.approx(5.0)
    assert idle > 4 * 5.0


def test_a_card_with_no_operation_is_idle_throughout():
    got = tracing.reduce(four_cards(with_card_3=False), 4)
    assert got["busy_s"] == pytest.approx(3 * 190 / 4 * 1e-6)
    assert readings(got)["device_idle_pct"] == pytest.approx((3 * 5 + 100) / 4)
    assert dict(got["breakdown"]["idle_gaps"])["between calls before window end"] == (
        pytest.approx(200e-6))


def test_the_roofline_counts_card_seconds():
    """The bytes over one card's bandwidth against the kernels' time summed
    over the cards: four cards each busy for a quarter of the least time
    read what one card busy for all of it reads."""
    least_us = (1 << 30) / 3.35e12 * 1e6
    one = [user("portbench.call", 0, 2 * least_us), X(K, "kernel", 0, least_us, device=0)]
    four = [user("portbench.call", 0, 2 * least_us)] + [
        X(K, "kernel", 0, least_us / 4, device=c) for c in range(4)]
    assert readings(tracing.reduce(one))["kernel_roofline"] == pytest.approx(100.0)
    assert readings(tracing.reduce(four, 4))["kernel_roofline"] == pytest.approx(100.0)
    assert readings(tracing.reduce(four, 4))["launches_per_call"] == 4


def test_a_copy_between_cards_counts_on_the_card_that_ran_it():
    """A peer copy has no ``args.device`` in the trace, only ``inDevice``
    (with ``fromDevice`` and ``toDevice``): it is busy time of that card."""
    ev = four_cards(with_card_3=False) + [
        X("Memcpy PtoP (Device -> Device)", "gpu_memcpy", 20, 80, fromDevice=2, inDevice=3,
          toDevice=3, bytes=1 << 20)]
    got = tracing.reduce(ev, 4)
    assert got["busy_s"] == pytest.approx((3 * 190 + 80) / 4 * 1e-6)
    assert got["kernels"] == 3 and got["kernel_s"] == pytest.approx(3 * 190e-6)
    assert dict(got["breakdown"]["device_ops"])["Memcpy PtoP"] == pytest.approx(80e-6)
