"""Swarm incentive points interface, a stub as in petals_tpu (and its
reference: "the intent is to let users limit the request rate and/or
express priority, not implemented")."""

from abc import ABC, abstractmethod


class SpendingPolicyBase(ABC):
    @abstractmethod
    def get_points(self, method: str, *args, **kwargs) -> float:
        ...


class NoSpendingPolicy(SpendingPolicyBase):
    def get_points(self, method: str, *args, **kwargs) -> float:
        return 0.0
