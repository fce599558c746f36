"""The serving engine's dispatch: on the CPU the eager k-step body (no
graph is ever captured, the static inputs are staged from the host
state, the launch counters do not move); on the card (tests marked
``cuda``, which skip here) the CUDA graphs of the decode step hold the
eager step's tokens for k = 1 and k = 8, count the decode kernel's
launches through replays, draw fresh numbers on every replay when
sampling, and read LoRA adapters copied into their storage after the
capture (``ops/lora.inject_adapters``, as ``serve --resume`` restores
them in place).  Imports no JAX, so it runs where only PyTorch is installed."""

import numpy as np
import pytest
import torch

from youku_mplug_tpu_torch import bridge
from youku_mplug_tpu_torch.models import gpt3 as tgpt3
from youku_mplug_tpu_torch.models.generation import GenerationConfig
from youku_mplug_tpu_torch.ops import decode_attention as dec
from youku_mplug_tpu_torch.runtime.precision import BF16_POLICY, FP32_POLICY
from youku_mplug_tpu_torch.serving import engine as engine_mod
from youku_mplug_tpu_torch.serving.engine import ServingEngine

torch.set_num_threads(1)
CFG = tgpt3.GPT3Config(vocab_size=512, hidden_size=256, num_hidden_layers=2,
                       num_attention_heads=4, max_position_embeddings=256)


def _engine(device, policy, config, seed=0, cfg=CFG):
    """A GPT-3 of head dim 64 (the decode kernel's width), seeded
    weights, 4 slots."""
    with device:
        lm = bridge.seeded_init(tgpt3.GPT3LM(cfg, policy), 0)
    return ServingEngine(lm, num_slots=4, max_len=64, prefill_buckets=(8,),
                         config=config,
                         generator=torch.Generator(device).manual_seed(seed))


def _serve(engine, k):
    rng = np.random.default_rng(0)
    for n in (3, 8, 1, 5, 6, 2):
        engine.submit(list(rng.integers(3, 512, size=n)),
                      max_new_tokens=12 + n)
    return {f.rid: f.tokens for f in engine.run_to_completion(
        steps_per_dispatch=k)}


GREEDY = GenerationConfig(max_new_tokens=20, eos_id=-1, pad_id=0)


def test_cpu_engine_runs_the_eager_body():
    """CPU tensors: every dispatch runs ``_decode_many_impl`` (no capture,
    no replay), the static inputs hold the host state, decode_steps
    counts k a dispatch, and the launch counters stay where they were."""
    cpu = torch.device("cpu")
    eng = _engine(cpu, FP32_POLICY, GREEDY)
    before = engine_mod._counts()
    single = _serve(eng, 1)
    steps_1 = eng.decode_steps
    eng8 = _engine(cpu, FP32_POLICY, GREEDY)
    assert _serve(eng8, 8) == single
    assert eng.graph_replays == eng8.graph_replays == 0
    assert not eng._graphs and not eng8._graphs and eng8._pool is None
    assert engine_mod._counts() == before
    assert 0 < steps_1 <= eng8.decode_steps  # k = 8 decodes dead tokens
    eng8._stage()
    np.testing.assert_array_equal(
        eng8._inputs.numpy(), np.stack([eng8.cache_len, eng8.valid_from,
                                        eng8.pos_offset, eng8.last_token]))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the decode step's CUDA graphs)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graph_steps_match_the_eager_step_on_the_card(card, monkeypatch):
    eager = _engine(card, BF16_POLICY, GREEDY)
    monkeypatch.setattr(eager, "_replay", eager._decode_many_impl)
    want = _serve(eager, 1)
    monkeypatch.undo()
    assert eager.graph_replays == 0
    for k in (1, 8):
        eng = _engine(card, BF16_POLICY, GREEDY)
        before = dec.write_decode_attention.launches
        assert _serve(eng, k) == want
        assert eng.graph_replays > 0 and k in eng._graphs
        # one launch a layer a decode step, the warm-up step included
        assert dec.write_decode_attention.launches - before \
            == CFG.num_hidden_layers * eng.decode_steps
        assert eng.graph_pool_bytes > 0


@pytest.mark.cuda
def test_graph_sampling_draws_fresh_numbers_every_replay(card):
    cfg = GenerationConfig(max_new_tokens=40, eos_id=-1, pad_id=0,
                           do_sample=True, top_k=0, top_p=1.0,
                           temperature=50.0)

    def draws(seed):
        eng = _engine(card, BF16_POLICY, cfg, seed)
        eng.submit([5, 6, 7])
        eng._admit()
        out = [eng._launch(1).cpu().clone() for _ in range(6)]
        assert eng.graph_replays == 6
        return [d.flatten().tolist() for d in out]

    first = draws(0)
    assert len({tuple(d) for d in first}) > 1
    assert draws(0) == first          # the same seed, the same draws
    assert draws(1) != first


@pytest.mark.cuda
def test_graph_reads_adapters_injected_after_capture(card, monkeypatch):
    """A LoRA decoder's decode step runs in the same graph replay: an
    engine captured while its adapters were zero serves, after
    inject_adapters copies trained ones into their storage, the tokens
    the eager step gives with those adapters."""
    import dataclasses

    from youku_mplug_tpu_torch.ops.lora import (
        extract_adapters,
        inject_adapters,
    )

    cfg = dataclasses.replace(CFG, lora_rank=4, lora_alpha=32.0)
    trained = _engine(card, BF16_POLICY, GREEDY, cfg=cfg)
    with torch.no_grad():
        for name, p in trained.model.named_parameters():
            if name.endswith("_b") and "lora_" in name:
                p.copy_(torch.randn(p.shape, generator=torch.Generator(
                    card).manual_seed(7), device=card) * 0.05)
    adapters = extract_adapters(trained.model)
    def tokens(eng):  # in submission order (a second run's rids go on)
        return [t for _, t in sorted(_serve(eng, 1).items())]

    monkeypatch.setattr(trained, "_replay", trained._decode_many_impl)
    want = tokens(trained)
    monkeypatch.undo()
    eng = _engine(card, BF16_POLICY, GREEDY, cfg=cfg)
    base = tokens(eng)  # captures with the zero adapters
    assert eng.graph_replays > 0 and base != want
    inject_adapters(eng.model, adapters)
    before = eng.graph_replays
    assert tokens(eng) == want
    assert eng.graph_replays > before
