# Architecture configs of the port: one module per ported arch, a copy of
# `repro/configs/<id>.py`. Each registers a zero-arg factory in
# repro_torch.config.ARCHS under its canonical (underscored) id.
