"""REST surface (geomesa-web analog): ``GeoMesaWebServer`` over any of
the port's stores."""

from .server import GeoMesaWebServer

__all__ = ["GeoMesaWebServer"]
