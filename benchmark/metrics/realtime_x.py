"""Seconds of audio designed a second: every stream-hop completed in the
window times its hop of audio, over the window's host-clock seconds."""


def read(record: dict):
    audio_s = record["hops"] * record["streams"] * record["hop"] / record["dims"]["sampling_rate"]
    return audio_s / record["window_s"]
