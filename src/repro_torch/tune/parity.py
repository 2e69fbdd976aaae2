"""Served-quality parity harness: compressed serving against the float
model (PyTorch port of the reference's ``tune/parity.py``).

The paper's headline result is a trade-off (up to 1.63x fewer P-LUTs at
a test-accuracy drop of at most 0.01); compression alone measures only
the left side.  This module measures the right side for the LM serving
stack: the compressed serving path against the uncompressed float
baseline of the *same trained parameters* on held-out token streams,
reporting

* per-token **top-1 agreement** (the LM analogue of test accuracy: how
  often greedy decoding picks the same token),
* mean **KL divergence** and **logit MSE** (distributional drift), and
* the **perplexity delta** against the stream's next tokens.

Forwards run eagerly under ``torch.inference_mode()`` on the parameters'
device (the reference jits one program per table set).  The metrics are
the reference's float32 ones (the log-softmax as it writes it, KL, MSE,
teacher-forced cross-entropy), computed where the logits are, on the
card: one batch of 4 x 64 positions over qwen3's 151936-token vocabulary
is 156 MB of float32, and the reference's host pass over it would take
seconds an evaluation.  Each position's sum over the vocabulary is taken
in float32, the sums over positions in float64 on the host; the CPU
tests hold the result to the reference's numpy sums.

:func:`trained_params` restores the latest checkpoint of a
``launch/train`` directory, or trains in process at smoke scale:
calibrated don't-care masks mean something only against a model whose
activation distributions do, which a randomly initialized network's do
not.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data import TokenStream
from repro_torch.nn.mlp import project_logits


def _device_batch(batch: dict, device) -> dict:
    """A batch's model inputs as tensors on ``device``: tokens as int64,
    a vlm's patches and an encdec model's frames as float32."""
    out = {"tokens": torch.as_tensor(np.asarray(batch["tokens"]),
                                     device=device).long()}
    for k in ("patches", "frames"):
        if batch.get(k) is not None:
            out[k] = torch.as_tensor(np.asarray(batch[k], np.float32),
                                     device=device)
    return out


# ---------------------------------------------------------------------------
# Full-sequence logits (all families)
# ---------------------------------------------------------------------------
@torch.inference_mode()
def model_logits(params, cfg: ArchConfig, batch: dict, lut_tables=None
                 ) -> torch.Tensor:
    """One exact full-sequence forward -> (B, T, V) logits over the token
    positions (a vlm's patch-prefix positions are dropped; an encdec
    model's encoder runs over the batch's frames first), on the
    parameters' device.  The family dispatch of
    :func:`repro_torch.calib.capture_model`, so parity runs the forward
    the capture calibrated."""
    from repro_torch.nn.transformer import (
        decoder_forward,
        encdec_forward,
        encoder_forward,
        hybrid_forward,
        rwkv_forward,
    )

    b = _device_batch(batch, params.embed.device)
    toks = b["tokens"]
    if cfg.family in ("dense", "moe", "vlm"):
        x, _ = decoder_forward(params, cfg, toks, patches=b.get("patches"),
                               lut_tables=lut_tables)
    elif cfg.family == "ssm":
        x, _ = rwkv_forward(params, cfg, toks, lut_tables=lut_tables)
    elif cfg.family == "hybrid":
        x, _ = hybrid_forward(params, cfg, toks, lut_tables=lut_tables)
    elif cfg.family == "encdec":
        enc = encoder_forward(params, cfg, b["frames"])
        x = encdec_forward(params, cfg, toks, enc, lut_tables=lut_tables)
    else:
        raise ValueError(f"model_logits: unknown family {cfg.family!r}")
    x = x[:, -toks.shape[1]:]
    return project_logits(x, params.lm_head, cfg, lut_tables)


def heldout_batches(cfg: ArchConfig, steps: int, batch_size: int = 2,
                    seq_len: int = 16, seed: int = 17) -> list[dict]:
    """Held-out evaluation batches (numpy): a :class:`TokenStream` on its
    own seed (disjoint from the training stream's), with labels for
    perplexity and a vlm's patches or an encdec model's frames drawn as
    the reference draws them, so both packages see the same numbers."""
    stream = TokenStream(cfg.vocab_size, seq_len, batch_size, seed=seed)
    rng = np.random.default_rng(seed)
    out = []
    for s in range(steps):
        b = dict(stream.batch_at(s))
        if cfg.family == "vlm":
            b["patches"] = np.asarray(
                rng.normal(size=(batch_size, cfg.n_patches, cfg.d_model)),
                np.float32)
        if cfg.family == "encdec":
            b["frames"] = np.asarray(
                rng.normal(size=(batch_size, cfg.n_frames, cfg.d_model)),
                np.float32)
        out.append(b)
    return out


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ParityMetrics:
    """Aggregated served-quality deltas of one table configuration."""

    top1_agreement: float     # fraction of positions with identical argmax
    kl: float                 # mean KL(ref || served) over positions
    logit_mse: float          # mean squared logit difference
    ppl_ref: float            # reference perplexity on the stream labels
    ppl_lut: float            # served perplexity on the stream labels
    n_tokens: int

    @property
    def top1_drop(self) -> float:
        """The paper's accuracy-drop analogue (what the budget bounds)."""
        return 1.0 - self.top1_agreement

    @property
    def ppl_delta(self) -> float:
        return self.ppl_lut - self.ppl_ref

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["top1_drop"] = self.top1_drop
        d["ppl_delta"] = self.ppl_delta
        return d

    def summary(self) -> str:
        return (f"top-1 agreement {self.top1_agreement:.4f} "
                f"(drop {self.top1_drop:.4f}), kl {self.kl:.3e}, "
                f"ppl {self.ppl_ref:.3f} -> {self.ppl_lut:.3f} "
                f"({self.ppl_delta:+.4f}) over {self.n_tokens} tokens")


def _log_softmax(logits: torch.Tensor) -> torch.Tensor:
    """The reference's float32 log-softmax, operation for operation."""
    z = logits - logits.amax(dim=-1, keepdim=True)
    return z - torch.log(torch.exp(z).sum(dim=-1, keepdim=True))


def _total(per_position: torch.Tensor) -> float:
    """Sum of per-position float32 sums, in float64 on the host."""
    return float(per_position.double().sum())


class ParityHarness:
    """Reference logits computed once; each table configuration pays one
    eager forward per batch.

    The sweep evaluates many table configurations against one baseline,
    so the reference forward and its log-probabilities stay on the
    parameters' device.  ``ref_tables`` swaps the baseline from the float
    model to another LUT configuration (the losslessness fixture:
    identical tables must measure exactly zero drop).
    """

    def __init__(self, cfg: ArchConfig, params, batches: list[dict],
                 ref_tables: dict | None = None):
        self.cfg = cfg
        self.params = params
        self.device = params.embed.device
        self.batches = [dict(b) for b in batches]
        if not self.batches:
            raise ValueError("ParityHarness: no evaluation batches")
        ref_cfg = dataclasses.replace(
            cfg, lut_activation=ref_tables is not None)
        with torch.inference_mode():
            self.ref_logits = [
                model_logits(params, ref_cfg, b, ref_tables).float()
                for b in self.batches]
            self.ref_logp = [_log_softmax(lg) for lg in self.ref_logits]
        self.labels = [
            torch.as_tensor(self._labels(b), device=self.device).long()
            for b in self.batches]

    @staticmethod
    def _labels(batch: dict) -> np.ndarray:
        lab = batch.get("labels")
        if lab is not None:
            return np.asarray(lab)
        return np.asarray(batch["tokens"])[:, 1:]

    @torch.inference_mode()
    def evaluate(self, lut_tables: dict | None) -> ParityMetrics:
        """Measure one serving-table configuration against the baseline."""
        lut_cfg = dataclasses.replace(
            self.cfg, lut_activation=lut_tables is not None)
        n_tok = agree = n_lab = 0
        kl_sum = sq_sum = ce_ref = ce_lut = 0.0
        for batch, ref_lg, ref_lp, labels in zip(
                self.batches, self.ref_logits, self.ref_logp, self.labels):
            lut_lg = model_logits(self.params, lut_cfg, batch,
                                  lut_tables).float()
            lut_lp = _log_softmax(lut_lg)
            n_tok += ref_lg.shape[0] * ref_lg.shape[1]
            agree += int((ref_lg.argmax(-1) == lut_lg.argmax(-1)).sum())
            kl_sum += _total((torch.exp(ref_lp) * (ref_lp - lut_lp)).sum(-1))
            sq_sum += _total(torch.square(ref_lg - lut_lg).sum(-1))
            # teacher-forced next-token CE against the stream labels
            t = labels.shape[1]
            ce_ref -= _total(ref_lp[:, :t].gather(-1, labels[..., None]))
            ce_lut -= _total(lut_lp[:, :t].gather(-1, labels[..., None]))
            n_lab += labels.numel()
        vocab = self.ref_logits[0].shape[-1]
        return ParityMetrics(
            top1_agreement=agree / n_tok,
            kl=kl_sum / n_tok,
            logit_mse=sq_sum / vocab / n_tok,
            ppl_ref=float(np.exp(ce_ref / n_lab)),
            ppl_lut=float(np.exp(ce_lut / n_lab)),
            n_tokens=n_tok,
        )


def served_parity(cfg: ArchConfig, params, batches: list[dict],
                  lut_tables: dict | None, *,
                  ref_tables: dict | None = None) -> ParityMetrics:
    """One-shot convenience wrapper over :class:`ParityHarness`."""
    return ParityHarness(cfg, params, batches,
                         ref_tables=ref_tables).evaluate(lut_tables)


# ---------------------------------------------------------------------------
# Greedy-decode comparison (artifact round-trip identity)
# ---------------------------------------------------------------------------
@torch.inference_mode()
def greedy_tokens(cfg: ArchConfig, params, batch: dict, n_new: int,
                  lut_tables: dict | None = None,
                  max_seq: int | None = None) -> list[list[int]]:
    """Greedy-decode ``n_new`` tokens through the serving path (eager
    prefill and decode steps on the parameters' device): the
    token-identity probe for tuned-artifact round trips.  Decoding starts
    at :func:`~repro_torch.serve.decode_start` (a vlm's after its patches);
    an encdec cache holds ``max_seq`` positions (the port's prefill pads
    it, where the reference's drops ``max_seq``)."""
    from repro_torch.serve.decode import decode_start, decode_step, prefill

    cfg = dataclasses.replace(cfg, lut_activation=lut_tables is not None)
    dev = _device_batch(batch, params.embed.device)
    t = decode_start(cfg, dev)
    max_seq = max_seq or (t + n_new)
    lg, cache = prefill(params, cfg, dev, max_seq=max_seq,
                        lut_tables=lut_tables)
    tok = lg[:, -1].argmax(-1)[:, None]
    toks = []
    for i in range(n_new):
        toks.append(tok)
        lg, cache = decode_step(params, cfg, cache, tok, t + i, lut_tables)
        tok = lg[:, -1].argmax(-1)[:, None]
    return torch.cat(toks, dim=1).tolist()


# ---------------------------------------------------------------------------
# Trained parameters (checkpoint or in-process fallback)
# ---------------------------------------------------------------------------
def trained_params(cfg: ArchConfig, *, ckpt_dir: str | None = None,
                   train_steps: int = 60, batch: int = 8, seq: int = 32,
                   lr: float = 1e-2, seed: int = 0, device=None
                   ) -> tuple[torch.nn.Module, dict]:
    """Parameters the parity harness should judge, frozen, on ``device``
    (the card unless named): the latest checkpoint under ``ckpt_dir``
    when one exists, else a short in-process training run on one device
    (under :class:`~repro_torch.train.Supervisor`, checkpointing into
    ``ckpt_dir`` when one is given, its starting state first, so the next
    tune run restores instead of retraining).  Returns ``(params,
    info)``, ``info`` as the reference's."""
    from repro_torch.bridge import train_state_from_checkpoint
    from repro_torch.device import resolve_device
    from repro_torch.optim import AdamWConfig, warmup_cosine_schedule
    from repro_torch.train import (
        Supervisor,
        TrainConfig,
        init_train_state,
        latest_step,
        make_train_step,
    )

    dev = resolve_device(device)
    tcfg = TrainConfig(
        optimizer=AdamWConfig(
            lr=warmup_cosine_schedule(lr, max(1, train_steps // 10),
                                      max(2, train_steps))),
        remat=False,
    )
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        try:
            state, step = train_state_from_checkpoint(ckpt_dir, cfg, tcfg,
                                                      device=dev)
        except ValueError as e:
            raise ValueError(
                f"trained_params: checkpoint under {ckpt_dir} does not "
                f"match arch {cfg.name!r} with default TrainConfig "
                f"({e}) — retrain or point --ckpt-dir elsewhere") from e
        return state["params"].requires_grad_(False), {
            "source": "checkpoint", "step": int(step), "ckpt_dir": ckpt_dir}

    stream = TokenStream(cfg.vocab_size, seq, batch, seed=seed)
    step = make_train_step(cfg, tcfg, dev)
    state = init_train_state(cfg, tcfg, device=dev)
    losses: list[float] = []

    def step_fn(state, b):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        return state, m

    if ckpt_dir:
        sup = Supervisor(ckpt_dir, ckpt_every=train_steps)
        state, _ = sup.run(state, step_fn, stream.batch_at, train_steps)
    else:
        for s in range(train_steps):
            state, _ = step_fn(state, stream.batch_at(s))
    return state["params"].requires_grad_(False), {
        "source": "in_process", "steps": train_steps,
        "loss_first": losses[0], "loss_last": losses[-1],
        "ckpt_dir": ckpt_dir,
    }
