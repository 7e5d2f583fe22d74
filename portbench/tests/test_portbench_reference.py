"""The plain reference against the port's CPU path, the controls and the
faults, on the small cells (tests/small.py).

A sound run compares equal on every number; the control (the reference
with each batch voted against the filter as the batch found it) and each
planted fault must come out not correct, in both filters' cells."""

import pytest

from goldrush_tpu_torch.io import fastq
from goldrush_tpu_torch.mibf import mibf as dm
from goldrush_tpu_torch.path import engine as eng_mod
from portbench.tests import small

CELLS = ["hs-cz.silver", "ce-direct.silver"]


@pytest.mark.parametrize("cell", CELLS)
def test_reference_matches_program(cell):
    out = small.run(cell, seed=11)
    assert small.correct(out), out["checks"]
    assert out["attempted"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    out = small.run(cell, seed=12, control=True)
    assert not small.correct(out), out["checks"]


def _no_insert(monkeypatch):
    monkeypatch.setattr(dm, "_insert_plain", lambda *a, **k: None)


def _half_batch_engine(monkeypatch):
    pack = eng_mod.GoldenPathEngine._pack_batch

    def half(self, batch):
        codes, lengths, full, T = pack(self, batch)
        lengths[len(batch) // 2:] = 0
        return codes, lengths, full, T
    monkeypatch.setattr(eng_mod.GoldenPathEngine, "_pack_batch", half)


def _half_fill_batch(monkeypatch):
    fill = dm.fill_presence_bits

    def half(bits, codes, lengths, *a, **k):
        h = max(codes.shape[0] // 2, 1)
        return fill(bits, codes[:h], lengths[:h], *a, **k)
    monkeypatch.setattr(dm, "fill_presence_bits", half)


def _altered_record(monkeypatch):
    write = fastq.PathWriter.write

    def altered(self, rid, suffix, seq, qual):
        seq = (b"T" if seq[:1] != b"T" else b"A") + seq[1:]
        return write(self, rid, suffix, seq, qual)
    monkeypatch.setattr(fastq.PathWriter, "write", altered)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_no_insert, _half_batch_engine,
                                   _half_fill_batch, _altered_record])
def test_engine_faults_are_caught(monkeypatch, fault, cell):
    fault(monkeypatch)
    out = small.run(cell, seed=13)
    assert not small.correct(out), out["checks"]
    if fault is _half_fill_batch:
        assert out["checks"]["present_slots_diff"][0] > 0

