"""Textbook scalar PID controller (reference ``controllers/pid.cpp:37-49``)."""

from attrs import define, field


@define
class PID:
    """Discrete PID with the reference's exact update law:
    u = Kp*e + Ki*integral*dt + Kd*(e - e_prev)/dt."""

    kp: float = field(default=1.0)
    ki: float = field(default=0.0)
    kd: float = field(default=0.0)
    _previous_error: float = field(default=0.0, init=False)
    _integral: float = field(default=0.0, init=False)
    _derivative: float = field(default=0.0, init=False)

    def reset(self) -> None:
        self._integral = 0.0
        self._derivative = 0.0

    def set_coefficients(self, kp: float, ki: float, kd: float) -> None:
        self.kp, self.ki, self.kd = kp, ki, kd

    def get_coefficients(self):
        return (self.kp, self.ki, self.kd)

    def compute(self, target: float, current: float, delta_time: float) -> float:
        error = target - current
        self._derivative = error - self._previous_error
        self._integral += error
        self._previous_error = error
        return (
            self.kp * error
            + self.ki * self._integral * delta_time
            + self.kd * self._derivative / delta_time
        )
