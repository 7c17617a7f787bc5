"""Reads TensorBoard event files back, for the tests and chip_smoke.py's
media phase: the summaries that ``ditsep_tpu_torch.utils.logging.
MetricsLogger`` (or the JAX package's) wrote."""
import struct
from pathlib import Path
from typing import List


def read_events(logdir: str) -> List[dict]:
    """Every summary value of the TensorBoard event files under
    ``logdir``, in order: ``{"step", "tag", "kind"}`` with ``kind``
    'scalar' (``value``), 'audio' (``wav`` bytes, ``fs``, ``frames``) or
    'image' (``png`` bytes). Reads the TFRecord framing directly (length,
    its CRC, the record, its CRC; the CRCs are not checked); needs
    tensorboardX for the protos."""
    from tensorboardX.proto.event_pb2 import Event
    out = []
    for path in sorted(Path(logdir).rglob("events.out.tfevents.*")):
        data = path.read_bytes()
        pos = 0
        while pos + 12 <= len(data):
            (n,) = struct.unpack("<Q", data[pos:pos + 8])
            event = Event.FromString(data[pos + 12:pos + 12 + n])
            pos += 12 + n + 4
            for v in event.summary.value:
                rec = {"step": event.step, "tag": v.tag}
                if v.HasField("audio"):
                    rec.update(kind="audio", wav=v.audio.encoded_audio_string,
                               fs=v.audio.sample_rate,
                               frames=v.audio.length_frames)
                elif v.HasField("image"):
                    rec.update(kind="image",
                               png=v.image.encoded_image_string)
                else:
                    rec.update(kind="scalar", value=v.simple_value)
                out.append(rec)
    return out
