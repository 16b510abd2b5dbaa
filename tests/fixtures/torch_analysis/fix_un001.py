"""--fix fixture — UN001 violations the rename engine must repair."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class EnergyReport:
    energy: float                            # -> energy_j
    power: float                             # -> power_w
    latency: float                           # -> latency_us
    num_jobs: int

    def to_dict(self):
        return {"energy": self.energy,
                "power": self.power,
                "latency": self.latency,
                "num_jobs": self.num_jobs}


def summarize(scale):
    rep = EnergyReport(energy=1.0, power=2.0, latency=3.0, num_jobs=4)
    return rep.energy * scale + rep.power + rep.latency
