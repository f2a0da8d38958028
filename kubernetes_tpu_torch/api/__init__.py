from .registry import Registry, ResourceInfo
from .client import Client, InProcClient, HttpClient
