"""The mean time of the window's codec decodes (`Codec.decode_latents`,
K4 in the SigmaVAE's blocks), timed around each call by the harness's
wrapper; a call ends in a host copy, so its time holds the device work."""


def read(ctx):
    calls = ctx.get("codec_s") or []
    return sum(calls) * 1e3 / len(calls) if calls else None
