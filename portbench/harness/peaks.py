"""Published peaks of the cards a run may land on (NVIDIA data sheets;
dense rates at the full power limit): device-memory bytes/s and non-tensor
float32 FLOP/s. The first name fragment that matches the card's name
wins, so the more specific names come first."""

CARDS = (("H200", 4.8e12, 67e12), ("H100 NVL", 3.9e12, 60e12),
         ("H100 PCIe", 2.0e12, 51e12), ("H100", 3.35e12, 67e12))


def card_rates(name: str):
    """(bytes/s, f32 FLOP/s) of the card, or None for a card not listed."""
    for frag, bw, f32 in CARDS:
        if frag in name:
            return bw, f32
    return None
