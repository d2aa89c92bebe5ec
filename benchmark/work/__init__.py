"""Operation and byte counts of the work a run asks for, from shapes and
from the reference's own strip lists; the same whatever implements it."""
