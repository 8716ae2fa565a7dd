"""The port's reprolint (``repro_torch.analysis``): each of its seven rules
on a bad and a clean fixture, the suppression grammar (the reference's,
so one pragma serves both linters), the JSON reporter's schema, the
donation rule's independence of statement order, and the capture audit's
refusal to run without a card.
"""
import json
import re
import textwrap

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.analysis import rule_ids as ref_rule_ids
from repro_torch.analysis import (all_rules, render_json, rule_ids,
                                  run_rules)
from repro_torch.analysis.core import discover


def lint(tmp_path, files, select=None):
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    project = discover([str(tmp_path)], root=str(tmp_path),
                       known_rules=rule_ids())
    rules = all_rules()
    if select is not None:
        rules = [r for r in rules if r.id in select]
    return run_rules(project, rules)


def rules_hit(findings):
    return {f.rule for f in findings}


def test_rule_ids_are_the_reference_ids():
    """No new id: a pragma the port's tree carries must parse under the
    reference's scanner too."""
    assert rule_ids() == ref_rule_ids()
    assert len(all_rules()) == 7


# -- host-sync-in-hot-path --------------------------------------------------


HOT_SYNC_BAD = """\
    import torch

    class CutoffController:
        def observe(self, times):
            x = torch.as_tensor(times, device="cuda")
            v = x.sum()
            a = v.item()
            b = float(torch.mean(x))
            c = v.cpu()
            d = x.tolist()
            torch.cuda.synchronize()
            e = x.to("cpu")
            return a + b
"""

HOT_SYNC_VIA_GRAPH = """\
    import torch

    class Step:
        def step(self):
            return self.x.sum().numpy()

    def capture(state):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            state.step()
        return g
"""

HOT_SYNC_CLEAN = """\
    import torch

    class Supervisor:
        def tick(self, now):
            # host bookkeeping: int()/float() of PLAIN host values is fine
            t = int(now) + 1
            tiny = float(torch.finfo(torch.float32).tiny)
            host = float(torch.tensor(2.0).to(torch.float64))
            return t, tiny, host

    def offline_report(x):
        # not reachable from any hot root: syncs are allowed
        return torch.as_tensor(x).sum().item()
"""


def test_host_sync_flags_torch_syncs_and_tainted_conversions(tmp_path):
    fs = lint(tmp_path, {"mod.py": HOT_SYNC_BAD},
              select={"host-sync-in-hot-path"})
    assert {f.line for f in fs} == {7, 8, 9, 10, 11, 12}


def test_host_sync_follows_a_graph_capture_to_its_body(tmp_path):
    fs = lint(tmp_path, {"mod.py": HOT_SYNC_VIA_GRAPH},
              select={"host-sync-in-hot-path"})
    assert len(fs) == 1 and fs[0].line == 5
    assert "Step.step" in fs[0].message


def test_host_sync_clean_host_bookkeeping(tmp_path):
    assert lint(tmp_path, {"mod.py": HOT_SYNC_CLEAN},
                select={"host-sync-in-hot-path"}) == []


def test_hot_path_marker_extends_roots(tmp_path):
    src = """\
        import torch

        # reprolint: hot-path
        def serve(x):
            return torch.as_tensor(x, device="cuda").sum().cpu()
    """
    fs = lint(tmp_path, {"mod.py": src}, select={"host-sync-in-hot-path"})
    assert len(fs) == 1


# -- donation-after-use -----------------------------------------------------


DONATION_BAD = """\
    import torch

    def run(step, state):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = step(state)
        g.replay()
        first = out
        g.replay()
        return first
"""

DONATION_CLEAN = """\
    import torch

    def run(step, state):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = step(state)
        st = g                       # bound before any replay: the object
        g.replay()
        keep = out.clone()           # a copy survives the next replay
        g.replay()
        again = out                  # bound after the last replay
        return keep, again, out, st
"""


def test_donation_read_after_replay_flags(tmp_path):
    fs = lint(tmp_path, {"mod.py": DONATION_BAD},
              select={"donation-after-use"})
    assert len(fs) == 1
    assert "first" in fs[0].message and fs[0].line == 10


def test_donation_clone_and_rebind_clean(tmp_path):
    assert lint(tmp_path, {"mod.py": DONATION_CLEAN},
                select={"donation-after-use"}) == []


def test_donation_a_replay_kills_only_its_own_graphs_handles(tmp_path):
    src = """\
        import torch

        def run(g, h, state):
            g.replay()
            a = g.state.logits
            h.replay()
            return a
    """
    assert lint(tmp_path, {"mod.py": src},
                select={"donation-after-use"}) == []


_HEADER = """\
import torch


def make():
    return 0


"""

_BLOCK = ("g{i} = make()\n"
          "with torch.cuda.graph(g{i}): o{i} = make()\n"
          "g{i}.replay()\n"
          "h{i} = o{i}\n"
          "g{i}.replay()\n"
          "r{i} = h{i} + 1\n")


def _interleave(seed, blocks):
    """Deterministic def-use-preserving merge of statement blocks."""
    idxs = [0] * len(blocks)
    out, state = [], seed
    while any(i < len(b) for i, b in zip(idxs, blocks)):
        live = [k for k, b in enumerate(blocks) if idxs[k] < len(b)]
        state = (state * 1103515245 + 12345) % (2 ** 31)
        k = live[state % len(live)]
        out.append(blocks[k][idxs[k]])
        idxs[k] += 1
    return out


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2 ** 30))
def test_donation_findings_order_insensitive(tmp_path_factory, seed):
    """Permuting independent statements never changes WHAT is flagged:
    every block's read of its stale handle is found, nothing else is."""
    blocks = [_BLOCK.format(i=i).splitlines() for i in range(3)]
    src = _HEADER + "\n".join(_interleave(seed, blocks)) + "\n"
    tmp = tmp_path_factory.mktemp(f"perm{seed % 997}")
    fs = lint(tmp, {"mod.py": src}, select={"donation-after-use"})
    names = sorted(re.search(r"`(h\d+)` is a handle", f.message).group(1)
                   for f in fs)
    assert names == ["h0", "h1", "h2"]


# -- colwise-rng ------------------------------------------------------------


COLWISE_BAD = """\
    import torch
    from repro_torch import random as R

    class CutoffController:
        def observe(self, key, times):
            n = times.shape[0]
            eps = R.normal(key, (4, n))
            u = torch.rand(n, device=times.device)
            return eps, u
"""

COLWISE_CLEAN = """\
    from repro_torch import random as R
    from repro_torch.core.runtime_model import api

    class CutoffController:
        def observe(self, key, times, zd):
            n = times.shape[0]
            eps = api.colwise_normal(key, 4, n)   # the sanctioned path
            z = R.normal(key, (16, zd))           # latent-shaped: fine
            return eps, z

    def init(key, n):
        return R.normal(key, (n, n))              # not on a hot path
"""


def test_colwise_rng_flags_width_shaped_raw_draws(tmp_path):
    fs = lint(tmp_path, {"mod.py": COLWISE_BAD}, select={"colwise-rng"})
    assert {f.line for f in fs} == {7, 8}


def test_colwise_rng_clean_api_and_latent_draws(tmp_path):
    assert lint(tmp_path, {"mod.py": COLWISE_CLEAN},
                select={"colwise-rng"}) == []


# -- nonatomic-checkpoint-write ---------------------------------------------


CKPT_BAD = """\
    import os

    def save(ckpt_dir, blob):
        path = os.path.join(ckpt_dir, "step_0000000005")
        with open(path, "w") as f:
            f.write(blob)
        os.rename(path, path + ".bak")
"""

CKPT_CLEAN = """\
    def save_log(log_path, blob):
        with open(log_path, "w") as f:     # not a checkpoint path
            f.write(blob)
"""

CKPT_STORE_EXEMPT = """\
    import os

    def publish(ckpt_dir, tmp):
        os.rename(tmp, ckpt_dir)           # the store OWNS the protocol
"""


def test_checkpoint_write_flags_direct_writes(tmp_path):
    fs = lint(tmp_path, {"mod.py": CKPT_BAD},
              select={"nonatomic-checkpoint-write"})
    assert {f.line for f in fs} == {5, 7}


def test_checkpoint_write_clean_and_store_exempt(tmp_path):
    assert lint(tmp_path, {"mod.py": CKPT_CLEAN},
                select={"nonatomic-checkpoint-write"}) == []
    assert lint(tmp_path, {"checkpoint/store.py": CKPT_STORE_EXEMPT},
                select={"nonatomic-checkpoint-write"}) == []


# -- event-kind-drift -------------------------------------------------------


EVENTS_BAD = """\
    EVENT_KINDS = (
        "alpha",
        "beta",
    )

    class Log:
        def emit(self, tick, kind):
            pass

    def go(log):
        log.emit(0, "alpha")
        log.emit(0, "gamma")
"""

EVENTS_CLEAN = """\
    EVENT_KINDS = ("alpha", "beta")

    class Log:
        def emit(self, tick, kind):
            pass

    def go(log, ev):
        log.emit(0, "alpha")
        log.emit(1, kind="beta")
        log.emit(2, ev.kind)        # dynamic: runtime check owns it
"""


def test_event_kind_drift_both_directions(tmp_path):
    fs = lint(tmp_path, {"mod.py": EVENTS_BAD}, select={"event-kind-drift"})
    blob = "\n".join(f.message for f in fs)
    assert len(fs) == 2
    assert "unregistered kind 'gamma'" in blob
    assert {f.line for f in fs if "never emitted" in f.message} == {3}


def test_event_kind_drift_clean(tmp_path):
    assert lint(tmp_path, {"mod.py": EVENTS_CLEAN},
                select={"event-kind-drift"}) == []


# -- static-argnum-width ----------------------------------------------------


STATIC_BAD = """\
    class Controller:
        def launch(self, mode, lo, run):
            key = (mode, self.k_samples, lo, self.n)
            self.graphs[key] = run()

        def bucket(self, n, run):
            self._graphs[(n, "observe")] = run()
"""

STATIC_CLEAN = """\
    class Server:
        def launch(self, kind, run):
            self.graphs[kind] = run()

        def serve(self, B, L, sampled, run):
            self.graphs[(B, L, sampled)] = run()
"""


def test_static_width_flags_width_keyed_graph_caches(tmp_path):
    fs = lint(tmp_path, {"mod.py": STATIC_BAD},
              select={"static-argnum-width"})
    assert {f.line for f in fs} == {4, 7}


def test_static_width_clean_bucket_keys(tmp_path):
    assert lint(tmp_path, {"mod.py": STATIC_CLEAN},
                select={"static-argnum-width"}) == []


# -- twin-epsilon-drift -----------------------------------------------------


TWIN_BAD = """\
    import numpy as np
    import torch

    def curve(x):
        return x / np.maximum(x, 1e-9)

    def curve_torch(x):
        return x / torch.clamp(x, min=1e-9)
"""

TWIN_CLEAN = """\
    import numpy as np
    import torch

    FLOOR = 1e-9

    def curve(x):
        return x / np.maximum(x, FLOOR)

    def curve_torch(x):
        return x / torch.clamp(x, min=FLOOR)

    def lonely(x):
        return x + 1e-9        # no _torch twin: not this rule's business
"""


def test_twin_epsilon_flags_inline_literals_in_twins(tmp_path):
    fs = lint(tmp_path, {"mod.py": TWIN_BAD},
              select={"twin-epsilon-drift"})
    assert {f.line for f in fs} == {5, 8}


def test_twin_epsilon_clean_shared_constant(tmp_path):
    assert lint(tmp_path, {"mod.py": TWIN_CLEAN},
                select={"twin-epsilon-drift"}) == []


# -- suppressions -----------------------------------------------------------


def test_suppression_with_reason_silences(tmp_path):
    src = DONATION_BAD.replace(
        "        return first\n",
        "        # reprolint: disable=donation-after-use -- a stale read on "
        "purpose\n        return first\n")
    assert lint(tmp_path, {"mod.py": src},
                select={"donation-after-use"}) == []


def test_suppression_without_reason_is_itself_a_finding(tmp_path):
    src = DONATION_BAD.replace(
        "        return first\n",
        "        return first  # reprolint: disable=donation-after-use\n")
    fs = lint(tmp_path, {"mod.py": src})
    assert rules_hit(fs) == {"bad-suppression", "donation-after-use"}


@pytest.mark.parametrize("rule", ["no-such-rule", "graph-after-replay"])
def test_suppression_naming_a_non_reference_id_is_refused(tmp_path, rule):
    src = f"""\
        # reprolint: disable={rule} -- says who
        x = 1
    """
    fs = lint(tmp_path, {"mod.py": src})
    assert rules_hit(fs) == {"bad-suppression"}


def test_malformed_pragma_is_flagged(tmp_path):
    fs = lint(tmp_path, {"mod.py": "x = 1  # reprolint disable everything\n"})
    assert rules_hit(fs) == {"bad-suppression"}


# -- reporters --------------------------------------------------------------


def test_json_reporter_schema(tmp_path):
    fs = lint(tmp_path, {"mod.py": DONATION_BAD},
              select={"donation-after-use"})
    doc = json.loads(render_json(fs))
    assert doc["version"] == 1
    assert doc["total"] == len(fs) == len(doc["findings"])
    assert doc["counts"] == {"donation-after-use": 1}
    f = doc["findings"][0]
    assert set(f) >= {"path", "line", "col", "rule", "message"}


def test_parse_error_is_reported_not_raised(tmp_path):
    fs = lint(tmp_path, {"mod.py": "def broken(:\n"})
    assert rules_hit(fs) == {"parse-error"}


# -- the CLI and the audit ---------------------------------------------------


def test_cli_strict_exit_codes(tmp_path, capsys):
    from repro_torch.analysis.__main__ import main

    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent(DONATION_BAD))
    good = tmp_path / "good.py"
    good.write_text(textwrap.dedent(DONATION_CLEAN))
    assert main([str(good), "--strict"]) == 0
    capsys.readouterr()
    assert main([str(bad), "--strict", "--format", "json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["total"] == 1 and doc["paths"] == [str(bad)]
    assert main([str(bad)]) == 0                 # advisory mode
    assert main([str(bad), "--select", "no-such-rule"]) == 2


def test_audit_without_a_card_raises(monkeypatch):
    from repro_torch.analysis import capture_audit
    from repro_torch.analysis.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        capture_audit.run_audit()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--audit", "--out", "unused.json"])
