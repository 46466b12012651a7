"""Community access control (paper §3, Figure 3).

Sector semantics: anyone in the public can *read*; only community members on
the write ACL can *write*. Unlike GFS/Hadoop (organisation-scoped accounts)
or Globus (virtual-organisation GSI), Sector is community-scoped with open
reads.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Set


class AclError(PermissionError):
    pass


@dataclass
class CommunityACL:
    community: Set[str] = field(default_factory=set)
    writers: Set[str] = field(default_factory=set)
    public_read: bool = True
    read_restricted: Set[str] = field(default_factory=set)  # files

    def add_member(self, user: str) -> None:
        self.community.add(user)

    def grant_write(self, user: str) -> None:
        if user not in self.community:
            raise AclError(f"{user} is not a community member")
        self.writers.add(user)

    def check_write(self, user: str) -> None:
        if user not in self.writers:
            raise AclError(f"{user} lacks write access")

    def check_read(self, user: str, file: str) -> None:
        if file in self.read_restricted and user not in self.community:
            raise AclError(f"{file} is restricted to the community")
        if not self.public_read and user not in self.community:
            raise AclError("reads are community-only on this cloud")
