"""Link model for agent-to-agent messages and KV-cache transfers.

Each directed link is a FIFO pipe with latency + bandwidth; transfers
serialize on the link (the availability horizon), which is what makes
proactive ("hinted") KV pushes overlap generation while reactive ones
serialize behind the request — the paper's Fig-7 mechanism.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.sim.clock import EventLoop

# Message-size model: tokens -> bytes on the wire (text + protocol framing)
BYTES_PER_TOKEN_WIRE = 6
MSG_HEADER_BYTES = 512          # per-message protocol/framing overhead
MSG_FIXED_LATENCY = 0.8e-3      # per-message RPC latency (s)


@dataclass
class Link:
    loop: EventLoop
    bandwidth: float = 12.5e9     # B/s (ICI/DCN-class for KV, NIC for msgs)
    latency: float = MSG_FIXED_LATENCY
    proc_time: float = 0.0        # per-message endpoint processing (serde,
                                  # protocol handling) — occupies the pipe
    name: str = "link"
    _free_at: float = field(default=0.0, repr=False)
    bytes_sent: float = field(default=0.0, repr=False)
    msgs_sent: int = field(default=0, repr=False)

    def transfer(self, nbytes: float, fn, extra_latency: float = 0.0):
        """Schedule ``fn`` at delivery time; returns the delivery time."""
        start = max(self.loop.now(), self._free_at)
        dur = nbytes / self.bandwidth + self.proc_time
        done = start + dur
        self._free_at = done
        deliver = done + self.latency + extra_latency
        self.bytes_sent += nbytes
        self.msgs_sent += 1
        self.loop.call_at(deliver, fn)
        return deliver

    def message_bytes(self, tokens: int) -> int:
        return MSG_HEADER_BYTES + tokens * BYTES_PER_TOKEN_WIRE

    @property
    def queue_delay(self) -> float:
        return max(0.0, self._free_at - self.loop.now())
