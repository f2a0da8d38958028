from .quantity import Quantity, parse_quantity
from .errors import (
    ApiError,
    NotFound,
    AlreadyExists,
    Conflict,
    Invalid,
    BadRequest,
    Expired,
)
