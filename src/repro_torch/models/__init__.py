"""The port's models: ``lm`` builds the decoder-only stacks (attention,
mamba, mLSTM and sLSTM blocks), ``encdec`` the encoder-decoder stack."""


def module_for(cfg):
    """The module that builds ``cfg``: ``models.encdec`` for the
    encoder-decoder substrate, else ``models.lm``."""
    from repro_torch.models import encdec, lm
    return encdec if cfg.arch_class == "encdec" else lm


def encoder_frames(cfg, seq: int) -> dict:
    """``make_source``'s ``enc_frames``/``enc_dim`` for ``cfg`` at ``seq``
    tokens a row: the reference launcher's ``seq // 4`` frames of
    ``d_model`` for the encoder-decoder substrate, none otherwise."""
    enc = cfg.arch_class == "encdec"
    return {"enc_frames": seq // 4 if enc else 0,
            "enc_dim": cfg.d_model if enc else 0}
